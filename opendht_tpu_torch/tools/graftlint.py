"""graftlint: static and dynamic invariant checks of the port's tree.

The port's counterpart of ``opendht_tpu/tools/graftlint.py``.  The seven
planes (``ast``, ``lock``, ``lower``, ``ranges``, ``budget``,
``strict``, ``all``), the rule names, the :class:`Finding` tuple, the
pragma grammar, ``--list-rules``, the exit codes (0 clean, 1 findings,
2 internal error) and the ``graftlint summary:`` line are JAX's.  What
each rule means is redesigned for eager PyTorch and CUDA graphs; the
registry is the port's own :data:`~opendht_tpu_torch.obs.ledger.ENTRY_POINTS`,
whose third column names the arguments a function overwrites in place
(the port's counterpart of a jit's ``donate_argnums``).

**Plane ``ast`` (imports no torch).**

* ``host-call-in-jit`` / ``tracer-coercion`` — JAX lints jit bodies and
  ``lax`` loop bodies.  The port has no tracer; its counterpart of a
  traced context is **a function reached from a CUDA-graph capture**:
  the statements under ``with torch.cuda.graph(...)`` and every package
  function they reach through the package's own call graph (names,
  imports, ``module.attr``, ``self.method`` across a class's bases and
  subclasses).  Inside such a function ``np.`` calls on a tensor, any
  ``random.`` / ``time.`` call, ``.item()`` / ``.tolist()`` / ``.cpu()``
  / ``.numpy()`` / ``int()`` / ``bool()`` / ``float()`` of a tensor, and
  ``torch.as_tensor(host, device=...)`` / ``host.to("cuda")`` (a
  host-to-device copy recorded into the graph, which the next replay
  repeats from a stale host buffer) are findings.  A parameter is a
  tensor unless its annotation says ``int`` / ``bool`` / ``float`` /
  ``str`` or a ``*Config``.
* ``sync-in-loop`` — inside a host ``for`` / ``while`` loop of
  ``models/``, ``parallel/`` or ``obs/``: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``,
  ``<event>.synchronize()`` and ``int()`` / ``bool()`` / ``float()`` of
  a tensor expression.  Unlike JAX, whose readbacks are spelled
  ``jax.device_get`` at the loop, the port hides them in helpers, so the
  rule follows calls to package functions that synchronize
  (transitively) and anchors at the loop's call site.  A sync already
  declared by a pragma does not propagate to the callers of its
  function: the burst loop's readback is declared once, at the burst.
* ``donated-reuse`` — a tensor passed at an overwritten position of an
  ``ENTRY_POINTS`` row and read again after the call without being
  rebound: its contents are no longer what the caller put there.
* ``registry-drift`` — a row names a function no module defines; a
  function writes a parameter in place (``p.copy_``, ``p[...] = ``,
  ``index_put_``, any in-place ``*_`` method, ``out=p``, or passing it
  to a callee that writes it) that its row does not list; or a row lists
  a parameter the function never writes.  The whole package is scanned.
* ``unhashable-static`` — JAX's static jit arguments become the port's
  Python-keyed caches: a list / dict / set literal passed to a
  ``functools.lru_cache`` / ``cache`` function, or at a parameter that
  becomes part of a dictionary key (the resident engines' graph keys,
  ``ResidentServeEngine._graph``) directly or through its callers.

**Plane ``lock``** is JAX's, unchanged: the port holds the same
lock-owning classes.

**Plane ``lower``** — eager torch lowers nothing.  The plane runs the
canonical workload (JAX's, at 2,048 nodes and 512 targets, reaching
every ``ENTRY_POINTS`` row) under :meth:`CostLedger.instrument` and a
``TorchDispatchMode`` observer:

* ``donation-drop`` — a declared overwritten argument whose tensors'
  ``_version`` did not move in a call; an undeclared one that moved is
  ``registry-drift``;
* ``f64-leak`` — a float64 tensor made inside an entry point;
* ``host-callback`` — a device/host copy or an ``aten._local_scalar_dense``
  inside a round-loop entry point;
* ``unexercised-entry`` — a row the workload never called.

**Plane ``ranges``** (``graftlint_ranges.py``) interprets the aten ops
of each entry point's first call on the CPU with integer intervals.
**Plane ``budget``** holds the kernel builds and the graph captures to
the budgets in the rows' fourth field.

**Plane ``strict``** replays JAX's seven strict workloads and the
resident open loop (its one readback a macro step).  On the card
every synchronizing CUDA call (``torch.cuda.set_sync_debug_mode``) made
inside a host loop must come through a pragma'd ``sync-in-loop`` site,
at most once for each time that site runs (one a burst, one a macro
step); on the CPU the dispatch observer flags rank promotion (a binary
elementwise op on two non-0-d operands of different ``ndim``) and NaN
in a float output.

Findings of ``lower``, ``ranges`` and ``strict`` anchor at the innermost
port frame that dispatched the op, so the pragma grammar suppresses
them as it does ``ast`` findings::

    # graftlint: disable=<rule>[,<rule>...] (<reason>)

The reason is mandatory; ``bad-pragma`` and ``stale-pragma`` are not
suppressible; the stale-pragma pass judges the rules of ``ast``,
``lock`` and ``ranges``.

Run: ``python -m opendht_tpu_torch.tools.graftlint --plane all
--device cpu`` (``--device`` defaults to ``cuda``).
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import os
import re
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# rule catalogue
# ---------------------------------------------------------------------------

RULES: Dict[str, str] = {
    "host-call-in-jit": "np./random./time. call, or a host-to-device "
                        "copy of host data, inside a function reached "
                        "from a CUDA-graph capture",
    "tracer-coercion": "float()/int()/bool()/.item()/.tolist()/.cpu()/"
                       ".numpy() of a tensor inside a function reached "
                       "from a CUDA-graph capture",
    "sync-in-loop": "device-to-host sync (direct, or through a package "
                    "function that syncs) inside a host loop of an "
                    "engine module",
    "unhashable-static": "unhashable literal passed where a Python cache "
                         "key is built",
    "donated-reuse": "tensor read after being passed at an overwritten "
                     "position of an ENTRY_POINTS function",
    "lock-discipline": "lock-owning class attribute mutated outside "
                       "'with self.<lock>'",
    "registry-drift": "ledger ENTRY_POINTS overwritten-argument column "
                      "disagrees with the functions' in-place writes",
    "bad-pragma": "malformed graftlint pragma (missing reason or "
                  "unknown rule)",
    "donation-drop": "declared overwritten argument not written in "
                     "place by the call",
    "f64-leak": "float64 tensor made inside an entry point",
    "host-callback": "device/host copy or scalar readback inside a "
                     "round-loop entry point",
    "unexercised-entry": "ENTRY_POINTS function not reached by the "
                         "canonical lint workload",
    "strict-replay": "strict workload broke a contract: an undeclared "
                     "or over-budget sync, rank promotion, or NaN",
    "narrow-cast-unproven": "narrowing integer cast whose operand "
                            "interval the prover cannot bound inside "
                            "the target dtype domain",
    "narrow-overflow": "u8/i16/u16 add/mul/accumulate whose proven "
                       "result interval escapes the dtype domain",
    "specialization-budget": "a kernel source built, or a graph key "
                             "captured, more often than its row's "
                             "declared budget",
    "lock-guard-read": "state flag written under a lock but read in a "
                       "branch test outside it (check-then-act)",
    "lock-order": "cross-class lock-acquisition cycle, or self-"
                  "deadlock on a non-reentrant Lock",
    "stale-pragma": "graftlint pragma whose rule no longer fires at "
                    "its site (dead suppression)",
}

# Rules whose findings anchor at real source lines and whose pragmas
# the stale-pragma pass judges, by the plane that emits them.
PLANE_RULES = {
    "ast": ("host-call-in-jit", "tracer-coercion", "sync-in-loop",
            "unhashable-static", "donated-reuse", "registry-drift"),
    "lock": ("lock-discipline", "lock-guard-read", "lock-order"),
    "ranges": ("narrow-cast-unproven", "narrow-overflow"),
}

PKG = "opendht_tpu_torch"
# Modules whose host for/while loops are checked for sync-in-loop.
SYNC_LOOP_PREFIXES = (f"{PKG}/models/", f"{PKG}/parallel/", f"{PKG}/obs/")
LEDGER_PATH = f"{PKG}/obs/ledger.py"
# Files beside the package that the import and pragma rules cover.
EXTRA_FILES = ("chip_smoke.py",)

# Attribute reads and method calls that yield HOST metadata of a tensor.
_META_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
               "_fields", "requires_grad"}
_META_METHODS = {"size", "numel", "dim", "element_size", "stride",
                 "data_ptr", "is_contiguous", "nelement", "get_device"}
_HOST_BUILTINS = {"len", "isinstance", "range", "type", "getattr",
                  "hasattr", "id", "callable", "repr", "str"}
# Methods that read a tensor back to the host.
_READBACKS = ("item", "tolist", "cpu", "numpy")
# torch namespaces whose calls return host values, not tensors.
_TORCH_HOST = ("cuda", "distributed", "backends", "get_num_threads",
               "set_num_threads", "is_tensor", "is_floating_point",
               "device", "dtype", "Generator", "get_default_dtype",
               "iinfo", "finfo", "manual_seed", "utils", "profiler",
               "are_deterministic_algorithms_enabled")
# Tensor reductions whose result, coerced, reads back.
_TENSOR_REDUCERS = {"sum", "any", "all", "max", "min", "amax", "amin",
                    "count_nonzero", "prod", "mean", "item"}
# Annotations that mark a parameter as a host value.
_HOST_ANN = re.compile(r"^(int|bool|float|str|bytes|dict|list|tuple|"
                       r"slice|[A-Za-z_]*Config)\b")
# View methods: a name bound to one aliases its receiver's storage.
_VIEW_METHODS = {"view", "reshape", "unbind", "select", "narrow",
                 "as_strided", "expand", "squeeze", "unsqueeze",
                 "transpose", "permute", "t", "flatten", "view_as",
                 "unflatten", "diagonal", "split", "chunk"}


class Finding(NamedTuple):
    path: str
    line: int
    col: int
    rule: str
    msg: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule}: "
                f"{self.msg}")


# ---------------------------------------------------------------------------
# pragmas (JAX's grammar)
# ---------------------------------------------------------------------------

_PRAGMA_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\- ]+?)\s*(?:\((.*)\))?\s*$")
_PRAGMA_HINT_RE = re.compile(r"#\s*graftlint\s*:")


def _comment_lines(src: str):
    """(lineno, text) of every real COMMENT token — pragma text inside
    string literals and docstrings must not parse as a pragma."""
    import io
    import tokenize
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return


def parse_pragmas(src: str, path: str
                  ) -> Tuple[Dict[int, set], List[Finding]]:
    """Per-line suppression sets plus ``bad-pragma`` findings."""
    pragmas: Dict[int, set] = {}
    bad: List[Finding] = []
    for i, text in _comment_lines(src):
        if not _PRAGMA_HINT_RE.search(text):
            continue
        m = _PRAGMA_RE.search(text)
        if not m:
            bad.append(Finding(path, i, 0, "bad-pragma",
                               "pragma must be '# graftlint: "
                               "disable=<rule>[,...] (<reason>)'"))
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = (m.group(2) or "").strip()
        unknown = sorted(r for r in rules if r not in RULES)
        if unknown:
            bad.append(Finding(path, i, 0, "bad-pragma",
                               f"unknown rule(s) {', '.join(unknown)}"))
            continue
        if not reason:
            bad.append(Finding(path, i, 0, "bad-pragma",
                               "pragma reason is mandatory: "
                               "disable=... (<why this is safe>)"))
            continue
        pragmas[i] = rules
    return pragmas, bad


def apply_pragmas(findings: Sequence[Finding],
                  pragmas: Dict[int, set]) -> List[Finding]:
    """Drop findings suppressed by a pragma on their line or the line
    above.  ``bad-pragma`` and ``stale-pragma`` are never
    suppressible."""
    out = []
    for f in findings:
        if f.rule not in ("bad-pragma", "stale-pragma"):
            for ln in (f.line, f.line - 1):
                if f.rule in pragmas.get(ln, ()):
                    break
            else:
                out.append(f)
            continue
        out.append(f)
    return out


def _pragmas_of_file(root: str, path: str) -> Dict[int, set]:
    p = path if os.path.isabs(path) else os.path.join(root, path)
    try:
        with open(p, encoding="utf-8") as fh:
            return parse_pragmas(fh.read(), path)[0]
    except OSError:
        return {}


def suppress_by_source(root: str, findings: Sequence[Finding],
                       raw_sink: Optional[List[Finding]] = None
                       ) -> List[Finding]:
    """Apply each flagged file's pragmas to findings anchored at real
    source lines; ``raw_sink`` receives the pre-suppression findings
    (the stale-pragma pass needs them)."""
    if raw_sink is not None:
        raw_sink.extend(findings)
    by_file: Dict[str, List[Finding]] = {}
    for f in findings:
        by_file.setdefault(f.path, []).append(f)
    out: List[Finding] = []
    for path, fs in by_file.items():
        out.extend(apply_pragmas(fs, _pragmas_of_file(root, path)))
    return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))


# ---------------------------------------------------------------------------
# per-module AST index and the package call graph
# ---------------------------------------------------------------------------

def _fn_params(fn) -> Tuple[str, ...]:
    a = fn.args
    return tuple(p.arg for p in a.posonlyargs + a.args)


def _all_params(fn) -> Tuple[str, ...]:
    """Positional parameters, then keyword-only ones."""
    return _fn_params(fn) + tuple(p.arg for p in fn.args.kwonlyargs)


def _call_root(node) -> Optional[str]:
    """Root name of a dotted call target (``np.linalg.norm`` → np)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _walk_same_scope(root):
    """``ast.walk`` that does not descend into nested function / lambda
    bodies (a nested ``def`` is a scope of its own)."""
    stack = [root]
    while stack:
        node = stack.pop()
        if node is not root and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _module_name_of(rel: str) -> str:
    mod = rel[:-3].replace(os.sep, ".").replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[:-len(".__init__")]
    return mod


class FnInfo(NamedTuple):
    mod: str
    qual: str             # "f", "Cls.m", "outer.<locals>.inner"
    cls: Optional[str]
    node: ast.AST
    path: str


class ModuleIndex:
    """What the planes need to know about one source file: its imports
    (resolved to absolute module names), its functions and classes."""

    def __init__(self, path: str, src: str, mod: Optional[str] = None):
        self.path = path
        self.src = src
        self.mod = mod or _module_name_of(path)
        self.is_pkg = path.replace(os.sep, "/").endswith("__init__.py")
        self.tree = ast.parse(src, filename=path)
        self.imports: Dict[str, str] = {}
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        self.functions: Dict[str, FnInfo] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.bases: Dict[str, List[str]] = {}
        self._collect_imports()
        self._collect_defs()

    def _abs(self, module: Optional[str], level: int) -> str:
        if not level:
            return module or ""
        parts = self.mod.split(".")
        if not self.is_pkg:
            parts = parts[:-1]
        if level > 1:
            parts = parts[:len(parts) - (level - 1)]
        return ".".join(parts + ([module] if module else []))

    def _collect_imports(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for al in node.names:
                    if al.asname:
                        self.imports[al.asname] = al.name
                    else:
                        root = al.name.split(".")[0]
                        self.imports[root] = root
            elif isinstance(node, ast.ImportFrom):
                mod = self._abs(node.module, node.level)
                for al in node.names:
                    self.from_imports[al.asname or al.name] = (mod,
                                                               al.name)

    def _collect_defs(self):
        def visit(body, prefix, cls):
            for node in body:
                if isinstance(node, ast.ClassDef) and not prefix:
                    self.classes[node.name] = node
                    self.bases[node.name] = [_dotted(b).split(".")[-1]
                                             for b in node.bases]
                    visit(node.body, node.name + ".", node.name)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    qual = prefix + node.name
                    info = FnInfo(self.mod, qual, cls, node, self.path)
                    self.functions.setdefault(qual, info)
                    visit(node.body, qual + ".<locals>.", None)
                elif hasattr(node, "body") and not isinstance(
                        node, ast.ClassDef):
                    for attr in ("body", "orelse", "finalbody"):
                        visit(getattr(node, attr, []) or [], prefix, cls)
                    for h in getattr(node, "handlers", ()):
                        visit(h.body, prefix, cls)
        visit(self.tree.body, "", None)

    # Compatibility with JAX's fixture helpers: the stdlib alias sets.
    def stdlib_roots(self, *mods: str) -> set:
        return {n for n, t in self.imports.items()
                if t.split(".")[0] in mods}

    def stdlib_members(self, *mods: str) -> set:
        return {n for n, (m, _) in self.from_imports.items()
                if m.split(".")[0] in mods}


class PackageIndex:
    """Every linted module, and call resolution across them."""

    def __init__(self, indices: Sequence[ModuleIndex]):
        self.modules: Dict[str, ModuleIndex] = {i.mod: i for i in indices}
        self.fns: Dict[Tuple[str, str], FnInfo] = {}
        self.class_mod: Dict[str, List[Tuple[str, str]]] = {}
        for idx in indices:
            for qual, info in idx.functions.items():
                self.fns[(idx.mod, qual)] = info
            for cname in idx.classes:
                self.class_mod.setdefault(cname, []).append(
                    (idx.mod, cname))
        self.methods_by_name: Dict[str, List[FnInfo]] = {}
        for info in self.fns.values():
            if info.cls is not None:
                self.methods_by_name.setdefault(
                    info.qual.split(".")[-1], []).append(info)
        self._bases: Dict[str, List[str]] = {}
        for idx in indices:
            self._bases.update(idx.bases)
        self._related: Dict[str, set] = {}
        self._resolved: Dict[tuple, List[FnInfo]] = {}
        self._nodes: Dict[int, list] = {}

    def nodes(self, node) -> list:
        """:func:`_walk_same_scope` of ``node``, computed once."""
        got = self._nodes.get(id(node))
        if got is None:
            got = self._nodes[id(node)] = list(_walk_same_scope(node))
        return got

    def related_classes(self, cls: str) -> set:
        """``cls``, its bases and its subclasses (by name, in the
        package)."""
        if cls in self._related:
            return self._related[cls]
        bases = self._bases
        out, todo = {cls}, [cls]
        while todo:                                   # ancestors
            c = todo.pop()
            for b in bases.get(c, ()):
                if b not in out:
                    out.add(b)
                    todo.append(b)
        grew = True
        while grew:                                   # descendants
            grew = False
            for c, bs in bases.items():
                if c not in out and any(b in out for b in bs):
                    out.add(c)
                    grew = True
        self._related[cls] = out
        return out

    def family_methods(self, name: str) -> List[FnInfo]:
        """Methods named ``name`` when they all belong to one class
        family (a receiver of unknown class then still resolves); none
        when unrelated classes share the name, or for container
        method names."""
        cands = self.methods_by_name.get(name, ())
        if not cands or name in _ORDER_DENY or name.startswith("__"):
            return []
        fam = self.related_classes(cands[0].cls)
        return list(cands) if all(c.cls in fam for c in cands) else []

    def _module_fn(self, mod: str, name: str) -> List[FnInfo]:
        info = self.fns.get((mod, name))
        if info is not None:
            return [info]
        idx = self.modules.get(mod)
        if idx is not None and name in idx.from_imports:  # re-export
            m2, n2 = idx.from_imports[name]
            if (m2, n2) != (mod, name):
                return self._module_fn(m2, n2)
        return []

    def _as_module(self, idx: ModuleIndex, name: str) -> Optional[str]:
        if name in idx.imports:
            return idx.imports[name]
        if name in idx.from_imports:
            m, n = idx.from_imports[name]
            full = f"{m}.{n}" if m else n
            if full in self.modules:
                return full
        return None

    def resolve(self, func, idx: ModuleIndex, scope: Optional[FnInfo],
                by_method_name: bool = False) -> List[FnInfo]:
        """Package functions a call target may denote (with
        ``by_method_name``, ``obj.m(...)`` of an unknown receiver
        resolves through :meth:`family_methods`)."""
        key = (id(func), id(scope), by_method_name)
        hit = self._resolved.get(key)
        if hit is None:
            hit = self._resolved[key] = self._resolve(func, idx, scope,
                                                      by_method_name)
        return hit

    def _resolve(self, func, idx, scope, by_method_name):
        if isinstance(func, ast.Name):
            name = func.id
            if scope is not None:                     # nested defs
                q = scope.qual
                while True:
                    hit = idx.functions.get(f"{q}.<locals>.{name}")
                    if hit is not None:
                        return [hit]
                    if ".<locals>." not in q:
                        break
                    q = q.rsplit(".<locals>.", 1)[0]
            if name in idx.functions and \
                    idx.functions[name].cls is None:
                return [idx.functions[name]]
            if name in idx.from_imports:
                m, n = idx.from_imports[name]
                return self._module_fn(m, n)
            return []
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name):
                if base.id in ("self", "cls") and scope is not None:
                    cls = scope.cls or (scope.qual.split(".")[0]
                                        if "." in scope.qual else None)
                    if cls and cls in idx.classes:
                        related = self.related_classes(cls)
                        return [f for f in self.methods_by_name.get(
                                    func.attr, ())
                                if f.cls in related]
                mod = self._as_module(idx, base.id)
                if mod is not None:
                    return self._module_fn(mod, func.attr)
            if by_method_name:
                return self.family_methods(func.attr)
        return []


# ---------------------------------------------------------------------------
# taint (is this expression a tensor?)
# ---------------------------------------------------------------------------

def _is_torch_tensor_call(call: ast.Call, torch_names: set) -> bool:
    """A call rooted at ``torch`` that returns a tensor (not a host
    query such as ``torch.cuda.*`` or ``torch.device``)."""
    d = _dotted(call.func)
    if not d:
        return False
    parts = d.split(".")
    if parts[0] not in torch_names:
        return False
    return len(parts) > 1 and parts[1] not in _TORCH_HOST


def _expr_tainted(node, tainted: set, torch_names: set = frozenset()
                  ) -> bool:
    """Does this expression (possibly) carry a tensor?  Tainted names
    and ``torch.*`` calls taint it, except behind metadata reads
    (``x.shape``, ``x.size()``, ``len(x)``, ...)."""
    if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
        return False
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _META_METHODS:
            return False
        if isinstance(f, ast.Attribute) and f.attr in _READBACKS:
            return False
        if isinstance(f, ast.Name) and (f.id in _HOST_BUILTINS or
                                        f.id in ("int", "float", "bool")):
            return False
        if torch_names and _is_torch_tensor_call(node, torch_names):
            return True
    if isinstance(node, ast.Name):
        return node.id in tainted
    for child in ast.iter_child_nodes(node):
        if _expr_tainted(child, tainted, torch_names):
            return True
    return False


def _tensor_params(fn) -> set:
    """Parameters of ``fn`` that may be tensors: all but ``self`` /
    ``cls`` and those annotated as host values."""
    out = set()
    a = fn.args
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        if p.arg in ("self", "cls"):
            continue
        ann = ast.unparse(p.annotation) if p.annotation is not None else ""
        if ann and _HOST_ANN.match(ann) and "Tensor" not in ann:
            continue
        out.add(p.arg)
    return out


# ---------------------------------------------------------------------------
# plane ast: functions reached from a CUDA-graph capture
# ---------------------------------------------------------------------------

def _is_graph_capture(item: ast.withitem) -> bool:
    e = item.context_expr
    return isinstance(e, ast.Call) and \
        _dotted(e.func).endswith("cuda.graph")


def captured_functions(pkg: PackageIndex) -> Tuple[Dict[int, FnInfo],
                                                   List[Tuple]]:
    """Functions reached from a ``with torch.cuda.graph(...)`` block
    (by id of their def node) and the capture blocks themselves as
    ``(ModuleIndex, scope, With)``."""
    blocks = []
    for idx in pkg.modules.values():
        for node in ast.walk(idx.tree):
            if isinstance(node, ast.With) and \
                    any(_is_graph_capture(i) for i in node.items):
                scope = None
                for info in idx.functions.values():
                    if node in list(ast.walk(info.node)) and (
                            scope is None or
                            len(info.qual) > len(scope.qual)):
                        scope = info
                blocks.append((idx, scope, node))
    reached: Dict[int, FnInfo] = {}
    todo: List[FnInfo] = []

    def add_calls(stmts, idx, scope):
        for s in stmts:
            for n in ast.walk(s):
                if isinstance(n, ast.Call):
                    for f in pkg.resolve(n.func, idx, scope):
                        if id(f.node) not in reached:
                            reached[id(f.node)] = f
                            todo.append(f)

    for idx, scope, w in blocks:
        add_calls(w.body, idx, scope)
    while todo:
        f = todo.pop()
        add_calls([f.node], pkg.modules[f.mod], f)
    return reached, blocks


class _CapturedLinter:
    """Taint lint of one captured context."""

    def __init__(self, idx: ModuleIndex, findings: List[Finding]):
        self.idx = idx
        self.findings = findings
        self.np_roots = idx.stdlib_roots("numpy")
        self.rand_roots = idx.stdlib_roots("random")
        self.time_roots = idx.stdlib_roots("time")
        self.rand_members = idx.stdlib_members("random")
        self.time_members = idx.stdlib_members("time")
        self.torch_names = idx.stdlib_roots("torch") | {"torch"}

    def lint(self, stmts, tainted: set):
        for _ in range(2):           # propagate through loop back-edges
            tainted = self._scan_block(stmts, set(tainted), report=False)
        self._scan_block(stmts, tainted, report=True)

    def _tainted(self, e, tainted) -> bool:
        return _expr_tainted(e, tainted, self.torch_names)

    def _scan_block(self, stmts, tainted: set, report: bool) -> set:
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if report:
                for node in _walk_same_scope(s):
                    if isinstance(node, ast.Call):
                        self._check_call(node, tainted)
            if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = s.value
                targets = (s.targets if isinstance(s, ast.Assign)
                           else [s.target])
                hot = value is not None and self._tainted(value, tainted)
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            if hot:
                                tainted.add(n.id)
                            elif not isinstance(s, ast.AugAssign):
                                tainted.discard(n.id)
            elif isinstance(s, ast.For):
                if self._tainted(s.iter, tainted):
                    for n in ast.walk(s.target):
                        if isinstance(n, ast.Name):
                            tainted.add(n.id)
                tainted = self._scan_block(s.body, tainted, report)
                tainted = self._scan_block(s.orelse, tainted, report)
            elif isinstance(s, ast.While):
                tainted = self._scan_block(s.body, tainted, report)
                tainted = self._scan_block(s.orelse, tainted, report)
            elif isinstance(s, ast.If):
                t1 = self._scan_block(s.body, set(tainted), report)
                t2 = self._scan_block(s.orelse, set(tainted), report)
                tainted = t1 | t2
            elif isinstance(s, ast.With):
                tainted = self._scan_block(s.body, tainted, report)
            elif isinstance(s, ast.Try):
                for blk in (s.body, s.orelse, s.finalbody):
                    tainted = self._scan_block(blk, tainted, report)
                for h in s.handlers:
                    tainted = self._scan_block(h.body, tainted, report)
        return tainted

    def _emit(self, node, rule, msg):
        self.findings.append(Finding(self.idx.path, node.lineno,
                                     node.col_offset, rule, msg))

    def _check_call(self, call: ast.Call, tainted: set):
        f = call.func
        root = _call_root(f)
        args_tainted = any(self._tainted(a, tainted) for a in call.args) \
            or any(self._tainted(k.value, tainted) for k in call.keywords)
        if isinstance(f, ast.Attribute) and root in self.np_roots \
                and args_tainted:
            self._emit(call, "host-call-in-jit",
                       f"numpy call '{ast.unparse(f)}' on a tensor inside "
                       f"a function reached from a CUDA-graph capture")
            return
        if isinstance(f, ast.Attribute) and \
                (root in self.rand_roots or root in self.time_roots):
            self._emit(call, "host-call-in-jit",
                       f"host '{ast.unparse(f)}' call inside a function "
                       f"reached from a CUDA-graph capture (a capture-"
                       f"time constant that every replay repeats)")
            return
        if isinstance(f, ast.Name) and \
                (f.id in self.rand_members or f.id in self.time_members):
            self._emit(call, "host-call-in-jit",
                       f"host '{f.id}()' call inside a function reached "
                       f"from a CUDA-graph capture")
            return
        # host data copied to the device under capture
        dev_kw = any(k.arg == "device" for k in call.keywords)
        d = _dotted(f)
        # ``torch.tensor`` always copies host data; ``torch.as_tensor``
        # does unless handed a tensor already on the card (a parameter
        # may be either: under a capture both spellings are suspect).
        if d.split(".")[-1] in ("as_tensor", "tensor") and \
                root in self.torch_names and dev_kw and call.args and \
                not (isinstance(call.args[0], ast.Call) and
                     _is_torch_tensor_call(call.args[0],
                                           self.torch_names)):
            self._emit(call, "host-call-in-jit",
                       f"'{d}(<host data>, device=...)' inside a function "
                       f"reached from a CUDA-graph capture: the capture "
                       f"records a copy from a host buffer that every "
                       f"replay repeats unchanged")
            return
        if isinstance(f, ast.Attribute) and f.attr in ("to", "cuda") and \
                not self._tainted(f.value, tainted) and \
                not isinstance(f.value, ast.Attribute) and \
                (f.attr == "cuda" or any(
                    (isinstance(a, ast.Constant) and
                     str(a.value).startswith("cuda")) for a in call.args)
                 or dev_kw):
            self._emit(call, "host-call-in-jit",
                       f"'.{f.attr}(...)' of host data to the card inside "
                       f"a function reached from a CUDA-graph capture")
            return
        if isinstance(f, ast.Name) and \
                f.id in ("float", "int", "bool", "complex") and \
                args_tainted:
            self._emit(call, "tracer-coercion",
                       f"'{f.id}()' reads a tensor back to a Python scalar "
                       f"inside a function reached from a CUDA-graph "
                       f"capture")
            return
        if isinstance(f, ast.Attribute) and f.attr in _READBACKS and \
                self._tainted(f.value, tainted):
            self._emit(call, "tracer-coercion",
                       f"'.{f.attr}()' of a tensor inside a function "
                       f"reached from a CUDA-graph capture")


def _lint_captured(pkg: PackageIndex, findings_by_path: Dict[str, list],
                   reached, blocks):
    for info in reached.values():
        idx = pkg.modules[info.mod]
        _CapturedLinter(idx, findings_by_path.setdefault(
            idx.path, [])).lint(info.node.body, _tensor_params(info.node))
    for idx, scope, w in blocks:
        tainted = _tensor_params(scope.node) if scope is not None else set()
        _CapturedLinter(idx, findings_by_path.setdefault(
            idx.path, [])).lint(w.body, tainted)


# ---------------------------------------------------------------------------
# plane ast: sync-in-loop, interprocedural
# ---------------------------------------------------------------------------

def _param_access(e, params: set) -> bool:
    """Is ``e`` a field, an element or a method result of a tensor
    parameter (``st.done``, ``x[0]``, ``st.done.all()``)?  A bare
    parameter name is not: it is as often a Python number."""
    if isinstance(e, ast.Call):
        if not isinstance(e.func, ast.Attribute) or \
                e.func.attr in _META_METHODS | set(_READBACKS):
            return False
        e = e.func.value
        if isinstance(e, ast.Name):
            return e.id in params
    if not isinstance(e, (ast.Attribute, ast.Subscript)):
        return False
    node = e
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
            return False
        node = node.value
    return isinstance(node, ast.Name) and node.id in params


def _device_names(fn_node, torch_names: set, nodes=None) -> set:
    """Names that may hold a tensor in this scope: bound from an
    expression holding a ``torch.*`` tensor call or another such name —
    unless the expression ends in a readback or is a numpy call — plus
    the tensor parameters, kept apart (``"\\0name"``) for
    :func:`_direct_sync`'s reductions."""
    out: set = set()
    params = (_tensor_params(fn_node)
              if isinstance(fn_node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) else set())
    nodes = nodes if nodes is not None else list(_walk_same_scope(fn_node))
    for _ in range(2):
        for n in nodes:
            if isinstance(n, ast.Assign) and n.value is not None:
                v = n.value
                if isinstance(v, ast.Call) and (
                        isinstance(v.func, ast.Attribute) and
                        v.func.attr in _READBACKS or
                        _call_root(v.func) in ("np", "numpy")):
                    continue
                if _expr_tainted(v, out, torch_names):
                    for t in n.targets:
                        for m in ast.walk(t):
                            if isinstance(m, ast.Name):
                                out.add(m.id)
    return out | {f"\0{p}" for p in params} | {
        f"\1{p}" for p in _numpy_names(fn_node, nodes)}


def _numpy_names(fn_node, nodes) -> set:
    """Names holding numpy arrays: parameters annotated ``np.ndarray``,
    names bound from a ``np.*`` call, a ``.numpy()``, or a field,
    element or arithmetic of such a name."""
    out: set = set()
    if isinstance(fn_node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = fn_node.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.annotation is not None and \
                    "ndarray" in ast.unparse(p.annotation):
                out.add(p.arg)

    def is_np(v) -> bool:
        if isinstance(v, ast.Call):
            if _call_root(v.func) in ("np", "numpy"):
                return True
            if isinstance(v.func, ast.Attribute):
                if v.func.attr == "numpy":
                    return True
                if v.func.attr in ("astype", "copy", "reshape", "sum",
                                   "any", "all", "max", "min"):
                    return is_np(v.func.value)
            return False
        if isinstance(v, (ast.Subscript, ast.Attribute)):
            return is_np(v.value)
        if isinstance(v, ast.BinOp):
            return is_np(v.left) or is_np(v.right)
        if isinstance(v, ast.UnaryOp):
            return is_np(v.operand)
        if isinstance(v, ast.Compare):
            return is_np(v.left)
        return isinstance(v, ast.Name) and v.id in out

    for _ in range(2):
        for n in nodes:
            if isinstance(n, ast.Assign) and is_np(n.value):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _direct_sync(node: ast.Call, dev_names: set,
                 torch_names: set) -> Optional[str]:
    """The sync spelled by this call, or None."""
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _READBACKS and \
                _call_root(f) not in ("np", "numpy") and \
                f"\1{_root_name(f.value)}" not in dev_names:
            return f".{f.attr}()"
        if f.attr == "synchronize":
            return (_dotted(f) if _call_root(f) in torch_names
                    else ".synchronize()")
    if isinstance(f, ast.Name) and f.id in ("bool", "int", "float") and \
            len(node.args) == 1:
        a = node.args[0]
        if _expr_tainted(a, dev_names, torch_names):
            return f"{f.id}()"
        # A reduction of a returned value (``done_of(st).all()``) or of
        # a tensor parameter's field (``st.done.all()``).
        if isinstance(a, ast.Call) and isinstance(a.func, ast.Attribute) \
                and a.func.attr in _TENSOR_REDUCERS:
            recv = a.func.value
            params = {p[1:] for p in dev_names if p.startswith("\0")}
            if isinstance(recv, ast.Call) and \
                    _call_root(recv.func) not in ("np", "numpy") or \
                    any(_param_access(e, params)
                        for e in ast.walk(recv)
                        if isinstance(e, (ast.Attribute, ast.Subscript))):
                return f"{f.id}(.{a.func.attr}())"
            # a NamedTuple-of-tensors field (``st.done.all()``) of a
            # local name not known to hold numpy
            if isinstance(recv, ast.Attribute) and \
                    isinstance(recv.value, ast.Name) and \
                    f"\1{recv.value.id}" not in dev_names and \
                    recv.value.id not in ("self", "cls"):
                return f"{f.id}(.{a.func.attr}())"
    return None


class SyncIndex:
    """Which package functions synchronize with the card (directly or
    through a callee), with a witness ``path:line what`` each."""

    def __init__(self, pkg: PackageIndex):
        self.pkg = pkg
        self.syncs: Dict[int, str] = {}
        self._pragmas: Dict[str, Dict[int, set]] = {}
        for idx in pkg.modules.values():
            self._pragmas[idx.path] = parse_pragmas(idx.src, idx.path)[0]
        infos = list(pkg.fns.values())
        self._dev = {}
        for info in infos:
            idx = pkg.modules[info.mod]
            tn = idx.stdlib_roots("torch") | {"torch"}
            self._dev[id(info.node)] = (
                _device_names(info.node, tn, pkg.nodes(info.node)), tn)
        changed = True
        while changed:
            changed = False
            for info in infos:
                if id(info.node) in self.syncs:
                    continue
                w = self._witness(info)
                if w is not None:
                    self.syncs[id(info.node)] = w
                    changed = True

    def _declared(self, path: str, line: int) -> bool:
        """A sync under a ``sync-in-loop`` or ``tracer-coercion``
        pragma is a declared readback: it does not propagate."""
        p = self._pragmas.get(path, {})
        rules = p.get(line, set()) | p.get(line - 1, set())
        return bool(rules & {"sync-in-loop", "tracer-coercion"})

    def _witness(self, info: FnInfo) -> Optional[str]:
        idx = self.pkg.modules[info.mod]
        dev, tn = self._dev[id(info.node)]
        for n in self.pkg.nodes(info.node):
            if not isinstance(n, ast.Call):
                continue
            if self._declared(idx.path, n.lineno):
                continue
            what = _direct_sync(n, dev, tn)
            if what is not None:
                return f"{what} at {idx.path}:{n.lineno}"
            for callee in self.pkg.resolve(n.func, idx, info,
                                           by_method_name=True):
                w = self.syncs.get(id(callee.node))
                if w is not None and callee.node is not info.node:
                    return f"'{callee.qual}' → {w}"
        return None

    def call_sync(self, call: ast.Call, idx: ModuleIndex,
                  scope: Optional[FnInfo]) -> Optional[Tuple[str, str]]:
        for callee in self.pkg.resolve(call.func, idx, scope,
                                       by_method_name=True):
            w = self.syncs.get(id(callee.node))
            if w is not None:
                return callee.qual, w
        return None


def _loop_bodies(scope_node):
    """Statements of every host loop in this scope (same-scope walk):
    the body of each ``for``, the test and body of each ``while``."""
    for inner in _walk_same_scope(scope_node):
        if isinstance(inner, (ast.For, ast.While)) and \
                inner is not scope_node:
            header = [inner.test] if isinstance(inner, ast.While) else []
            yield inner, header + inner.body


def _lint_sync_in_loop(idx: ModuleIndex, pkg: PackageIndex,
                       sx: Optional["SyncIndex"],
                       findings: List[Finding]):
    tn = idx.stdlib_roots("torch") | {"torch"}
    scopes = [(info, info.node) for info in idx.functions.values()]
    scopes.append((None, idx.tree))
    for info, node in scopes:
        dev = _device_names(node, tn, pkg.nodes(node))
        seen = set()
        for _loop, stmts in _loop_bodies(node):
            for s in stmts:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                    continue
                for n in _walk_same_scope(s):
                    if not isinstance(n, ast.Call) or id(n) in seen:
                        continue
                    seen.add(id(n))
                    what = _direct_sync(n, dev, tn)
                    if what is not None:
                        findings.append(Finding(
                            idx.path, n.lineno, n.col_offset,
                            "sync-in-loop",
                            f"'{what}' inside a host loop — a per-"
                            f"iteration device-to-host sync serializes "
                            f"the round pipeline"))
                        continue
                    if sx is None:
                        continue
                    hit = sx.call_sync(n, idx, info)
                    if hit is not None:
                        findings.append(Finding(
                            idx.path, n.lineno, n.col_offset,
                            "sync-in-loop",
                            f"call to '{hit[0]}' inside a host loop "
                            f"syncs ({hit[1]}) — a per-iteration "
                            f"readback hidden in a helper"))


# ---------------------------------------------------------------------------
# plane ast: the registry (ENTRY_POINTS), in-place writes
# ---------------------------------------------------------------------------

def _literal(node, names: Dict[str, str]):
    """``ast.literal_eval`` that also takes f-strings over module string
    constants (the ledger spells modules ``f"{_PKG}.models.swarm"``)."""
    if isinstance(node, ast.JoinedStr):
        out = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                out.append(str(v.value))
            elif isinstance(v, ast.FormattedValue) and \
                    isinstance(v.value, ast.Name) and \
                    v.value.id in names:
                out.append(names[v.value.id])
            else:
                raise ValueError("unsupported f-string in ENTRY_POINTS")
        return "".join(out)
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(_literal(e, names) for e in node.elts)
    return ast.literal_eval(node)


def parse_entry_points(ledger_src: str
                       ) -> List[Tuple[str, str, Tuple, Optional[int]]]:
    """The ENTRY_POINTS literal read out of ledger.py without importing
    it; rows normalize to ``(module, attr, overwritten_argnums,
    budget-or-None)``."""
    tree = ast.parse(ledger_src)
    names: Dict[str, str] = {}
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and isinstance(node.value,
                                                      ast.Constant) and \
                    isinstance(node.value.value, str):
                names[t.id] = node.value.value
            if isinstance(t, ast.Name) and t.id == "ENTRY_POINTS":
                val = _literal(node.value, names)
                return [(r[0], r[1], tuple(r[2]),
                         r[3] if len(r) > 3 else None) for r in val]
    raise ValueError("ENTRY_POINTS literal not found in ledger source")


def _entry_points_line(ledger_src: str) -> int:
    for node in ast.parse(ledger_src).body:
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        if any(isinstance(t, ast.Name) and t.id == "ENTRY_POINTS"
               for t in targets):
            return node.lineno
    return 1


def _root_name(node) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_alias_expr(node, aliases: Dict[str, int]) -> Optional[int]:
    """The parameter whose storage ``node`` shares (a name, a field, a
    subscript or a view of one), or None."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _VIEW_METHODS:
        return _is_alias_expr(node.func.value, aliases)
    if isinstance(node, (ast.Name, ast.Attribute, ast.Subscript)):
        r = _root_name(node)
        if r in aliases:
            return aliases[r]
    return None


class WriteIndex:
    """Which parameters each package function writes in place, with the
    line of one write each (fixpoint through package callees)."""

    def __init__(self, pkg: PackageIndex):
        self.pkg = pkg
        self.writes: Dict[int, Dict[int, int]] = {}
        infos = list(pkg.fns.values())
        changed = True
        while changed:
            changed = False
            for info in infos:
                w = self._scan(info)
                if w != self.writes.get(id(info.node)):
                    self.writes[id(info.node)] = w
                    changed = True

    def _scan(self, info: FnInfo) -> Dict[int, int]:
        params = _all_params(info.node)
        aliases = {p: i for i, p in enumerate(params)
                   if p not in ("self", "cls")}
        idx = self.pkg.modules[info.mod]
        out: Dict[int, int] = {}

        def hit(i, line):
            if i is not None and i not in out:
                out[i] = line

        nodes = self.pkg.nodes(info.node)
        for _ in range(2):                      # aliases, then writes
            for n in nodes:
                if isinstance(n, ast.Assign):
                    src = _is_alias_expr(n.value, aliases)
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            if src is not None:
                                aliases.setdefault(t.id, src)
                        elif isinstance(t, (ast.Tuple, ast.List)) and \
                                src is not None:
                            for e in t.elts:
                                if isinstance(e, ast.Name):
                                    aliases.setdefault(e.id, src)
        for n in nodes:
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    elts = t.elts if isinstance(t, (ast.Tuple,
                                                    ast.List)) else [t]
                    for e in elts:
                        if isinstance(e, ast.Subscript) and not (
                                isinstance(e.slice, ast.Constant) and
                                isinstance(e.slice.value, str)):
                            r = _root_name(e)
                            if r in aliases:
                                hit(aliases[r], e.lineno)
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Attribute) and f.attr.endswith("_") and \
                    not f.attr.startswith("__"):
                r = _root_name(f.value)
                if r in aliases:
                    hit(aliases[r], n.lineno)
            for k in n.keywords:
                if k.arg == "out":
                    r = _root_name(k.value)
                    if r in aliases:
                        hit(aliases[r], n.lineno)
            for callee in self.pkg.resolve(f, idx, info):
                if callee.node is info.node:
                    continue
                cw = self.writes.get(id(callee.node), {})
                if not cw:
                    continue
                cparams = _all_params(callee.node)
                offset = 1 if callee.cls is not None and cparams and \
                    cparams[0] in ("self", "cls") else 0
                for i, a in enumerate(n.args):
                    if i + offset in cw:
                        r = _root_name(a)
                        if r in aliases:
                            hit(aliases[r], n.lineno)
                for k in n.keywords:
                    if k.arg in cparams and cparams.index(k.arg) in cw:
                        r = _root_name(k.value)
                        if r in aliases:
                            hit(aliases[r], n.lineno)
        return out


def check_registry(ledger_src: str, pkg: PackageIndex,
                   ledger_path: str = LEDGER_PATH,
                   writes: Optional[WriteIndex] = None) -> List[Finding]:
    """The ENTRY_POINTS rows against the functions they name."""
    findings: List[Finding] = []
    try:
        entries = parse_entry_points(ledger_src)
    except Exception as e:
        return [Finding(ledger_path, 1, 0, "registry-drift",
                        f"cannot parse ENTRY_POINTS: {e}")]
    ep_line = _entry_points_line(ledger_src)
    writes = writes or WriteIndex(pkg)
    for mod, attr, donate, _budget in entries:
        info = pkg.fns.get((mod, attr))
        if info is None:
            where = "a module not in the scanned set" \
                if mod not in pkg.modules else pkg.modules[mod].path
            findings.append(Finding(
                ledger_path, ep_line, 0, "registry-drift",
                f"registered entry point {mod}.{attr}: no function of "
                f"that name in {where} (renamed or removed?)"))
            continue
        params = _fn_params(info.node)
        wrote = writes.writes.get(id(info.node), {})
        for i, line in sorted(wrote.items()):
            if i not in donate:
                findings.append(Finding(
                    info.path, line, 0, "registry-drift",
                    f"{mod}.{attr} writes parameter {i} "
                    f"('{params[i]}') in place but its ENTRY_POINTS row "
                    f"lists {tuple(donate)}"))
        for i in donate:
            if i not in wrote:
                name = params[i] if i < len(params) else "?"
                findings.append(Finding(
                    ledger_path, ep_line, 0, "registry-drift",
                    f"{mod}.{attr}: the row lists parameter {i} "
                    f"('{name}') as overwritten in place, but the "
                    f"function never writes it"))
    return findings


# ---------------------------------------------------------------------------
# plane ast: donated-reuse (JAX's liveness walk over the row table)
# ---------------------------------------------------------------------------

class JitInfo(NamedTuple):
    """A registered function as the donation walk sees it."""
    name: str
    params: Tuple[str, ...]
    donate_argnums: Tuple[int, ...]
    line: int


def _donation_table(ledger_src: str, pkg: PackageIndex
                    ) -> Dict[int, JitInfo]:
    out: Dict[int, JitInfo] = {}
    try:
        entries = parse_entry_points(ledger_src)
    except Exception:
        return out
    for mod, attr, donate, _b in entries:
        info = pkg.fns.get((mod, attr))
        if info is not None and donate:
            out[id(info.node)] = JitInfo(attr, _fn_params(info.node),
                                         tuple(donate), info.node.lineno)
    return out


def _donations_in_stmt(s, idx, pkg, scope, table):
    events, assigned = [], set()
    if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = s.targets if isinstance(s, ast.Assign) else [s.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    assigned.add(n.id)
    for node in _walk_same_scope(s):
        if not isinstance(node, ast.Call):
            continue
        for callee in pkg.resolve(node.func, idx, scope):
            info = table.get(id(callee.node))
            if info is None:
                continue
            for pos in info.donate_argnums:
                arg = None
                if pos < len(node.args):
                    arg = node.args[pos]
                elif pos < len(info.params):
                    for kw in node.keywords:
                        if kw.arg == info.params[pos]:
                            arg = kw.value
                if isinstance(arg, ast.Name):
                    events.append((arg.id, node.lineno, info.name))
    return events, assigned


def _flag_donated_uses(node, donated: dict, idx, findings):
    if not donated:
        return
    for n in _walk_same_scope(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) and \
                n.id in donated:
            line, callee = donated[n.id]
            findings.append(Finding(
                idx.path, n.lineno, n.col_offset, "donated-reuse",
                f"'{n.id}' read after being passed to '{callee}' at line "
                f"{line}, which overwrites it in place — it no longer "
                f"holds what this function put there"))
            del donated[n.id]


def _scan_donations(stmts, idx, pkg, scope, table, donated, findings):
    """JAX's linear liveness walk: donated[name] = (line, callee); a
    later read of the name without rebinding is a finding."""
    for s in stmts:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        if isinstance(s, ast.For):
            _flag_donated_uses(s.iter, donated, idx, findings)
            for _ in range(2):
                _scan_donations(s.body, idx, pkg, scope, table, donated,
                                findings)
            _scan_donations(s.orelse, idx, pkg, scope, table, donated,
                            findings)
            continue
        if isinstance(s, ast.While):
            for _ in range(2):
                _flag_donated_uses(s.test, donated, idx, findings)
                _scan_donations(s.body, idx, pkg, scope, table, donated,
                                findings)
            _scan_donations(s.orelse, idx, pkg, scope, table, donated,
                            findings)
            continue
        if isinstance(s, ast.If):
            _flag_donated_uses(s.test, donated, idx, findings)
            d1, d2 = dict(donated), dict(donated)
            _scan_donations(s.body, idx, pkg, scope, table, d1, findings)
            _scan_donations(s.orelse, idx, pkg, scope, table, d2,
                            findings)
            donated.clear()
            donated.update({**d1, **d2})
            continue
        if isinstance(s, ast.With):
            for item in s.items:
                _flag_donated_uses(item.context_expr, donated, idx,
                                   findings)
            _scan_donations(s.body, idx, pkg, scope, table, donated,
                            findings)
            continue
        if isinstance(s, ast.Try):
            for blk in (s.body, s.orelse, s.finalbody):
                _scan_donations(blk, idx, pkg, scope, table, donated,
                                findings)
            for h in s.handlers:
                _scan_donations(h.body, idx, pkg, scope, table, donated,
                                findings)
            continue
        events, assigned = _donations_in_stmt(s, idx, pkg, scope, table)
        _flag_donated_uses(s, donated, idx, findings)
        for name in assigned:
            donated.pop(name, None)
        for name, line, callee in events:
            if name not in assigned:
                donated[name] = (line, callee)


def _lint_donated_reuse(idx, pkg, table, findings):
    if not table:
        return
    for info in idx.functions.values():
        _scan_donations(info.node.body, idx, pkg, info, table, {},
                        findings)


# ---------------------------------------------------------------------------
# plane ast: unhashable-static (Python-keyed caches)
# ---------------------------------------------------------------------------

_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
               ast.SetComp, ast.GeneratorExp)


def _is_cache_decorated(fn) -> bool:
    for dec in fn.decorator_list:
        d = _dotted(dec.func if isinstance(dec, ast.Call) else dec)
        if d.split(".")[-1] in ("lru_cache", "cache"):
            return True
    return False


def key_positions(pkg: PackageIndex) -> Dict[int, set]:
    """Parameter names of each function that end up in a Python cache
    key: every parameter of an ``lru_cache`` / ``cache`` function, the
    parameters a function puts in a dictionary key (``key = (a, b)``;
    ``key in self.graphs`` / ``self.graphs[key]``), and — through the
    call graph — the parameters a caller passes on to those."""
    keyed: Dict[int, set] = {}
    for info in pkg.fns.values():
        fn = info.node
        params = set(_fn_params(fn)) - {"self", "cls"}
        if _is_cache_decorated(fn):
            keyed[id(fn)] = set(params)
            continue
        tuples: Dict[str, set] = {}
        for n in pkg.nodes(fn):
            if isinstance(n, ast.Assign) and isinstance(n.value,
                                                        ast.Tuple):
                names = {e.id for e in n.value.elts
                         if isinstance(e, ast.Name)}
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        tuples[t.id] = names
        used: set = set()
        for n in pkg.nodes(fn):
            key = None
            if isinstance(n, ast.Compare) and len(n.ops) == 1 and \
                    isinstance(n.ops[0], (ast.In, ast.NotIn)) and \
                    isinstance(n.comparators[0], ast.Attribute):
                key = n.left
            elif isinstance(n, ast.Subscript) and \
                    isinstance(n.value, ast.Attribute) and \
                    isinstance(n.value.value, ast.Name) and \
                    n.value.value.id == "self":
                key = n.slice
            if key is None:
                continue
            if isinstance(key, ast.Name) and key.id in tuples:
                used |= tuples[key.id]
            elif isinstance(key, ast.Tuple):
                used |= {e.id for e in key.elts if isinstance(e, ast.Name)}
        used &= params
        if used:
            keyed[id(fn)] = used
    changed = True
    while changed:                      # callers passing parameters on
        changed = False
        for info in pkg.fns.values():
            idx = pkg.modules[info.mod]
            params = set(_fn_params(info.node)) - {"self", "cls"}
            mine = set(keyed.get(id(info.node), ()))
            for n in pkg.nodes(info.node):
                if not isinstance(n, ast.Call):
                    continue
                for callee in pkg.resolve(n.func, idx, info):
                    ks = keyed.get(id(callee.node))
                    if not ks or callee.node is info.node:
                        continue
                    cps = list(_fn_params(callee.node))
                    if cps and cps[0] in ("self", "cls"):
                        cps = cps[1:]
                    for i, a in enumerate(n.args):
                        if i < len(cps) and cps[i] in ks and \
                                isinstance(a, ast.Name) and a.id in params:
                            mine.add(a.id)
                    for k in n.keywords:
                        if k.arg in ks and isinstance(k.value, ast.Name) \
                                and k.value.id in params:
                            mine.add(k.value.id)
            if mine and mine != keyed.get(id(info.node)):
                keyed[id(info.node)] = mine
                changed = True
    return keyed


def _lint_unhashable_static(idx, pkg, keyed, findings):
    for info in list(idx.functions.values()) + [None]:
        node = info.node if info is not None else idx.tree
        for n in _walk_same_scope(node):
            if not isinstance(n, ast.Call):
                continue
            for callee in pkg.resolve(n.func, idx, info,
                                      by_method_name=True):
                ks = keyed.get(id(callee.node))
                if not ks:
                    continue
                cps = list(_fn_params(callee.node))
                if callee.cls is not None and cps and \
                        cps[0] in ("self", "cls"):
                    cps = cps[1:]
                for i, a in enumerate(n.args):
                    if i < len(cps) and cps[i] in ks and \
                            isinstance(a, _UNHASHABLE):
                        findings.append(Finding(
                            idx.path, a.lineno, a.col_offset,
                            "unhashable-static",
                            f"unhashable {type(a).__name__.lower()} "
                            f"literal for '{cps[i]}' of "
                            f"'{callee.qual}', which builds a Python "
                            f"cache key from it — every call raises"))
                for k in n.keywords:
                    if k.arg in ks and isinstance(k.value, _UNHASHABLE):
                        findings.append(Finding(
                            idx.path, k.value.lineno, k.value.col_offset,
                            "unhashable-static",
                            f"unhashable literal for '{k.arg}' of "
                            f"'{callee.qual}', which builds a Python "
                            f"cache key from it"))
                break


# ---------------------------------------------------------------------------
# plane lock (JAX's, unchanged)
# ---------------------------------------------------------------------------

def _lint_lock_discipline(idx: ModuleIndex, findings: List[Finding]):
    for node in idx.tree.body:
        if isinstance(node, ast.ClassDef):
            _lock_class_scan(idx, node, findings)


def _lock_attrs_of(cls: ast.ClassDef) -> Dict[str, str]:
    """``{attr: kind}`` of every ``self.<attr> = threading.Lock()`` /
    ``RLock()`` / ``Condition()`` the class owns."""
    locks: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):
            f = node.value.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if name in ("Lock", "RLock", "Condition"):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        locks[t.attr] = name
    return locks


def _self_attr_of_store(t) -> Optional[Tuple[str, ast.AST]]:
    node = t
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        base = node.value
        while isinstance(base, (ast.Attribute, ast.Subscript)):
            base = base.value
        if isinstance(base, ast.Name) and base.id == "self":
            attr_node = node
            while isinstance(attr_node.value, (ast.Attribute,
                                               ast.Subscript)):
                attr_node = attr_node.value if isinstance(
                    attr_node.value, ast.Attribute) else \
                    attr_node.value.value
            if isinstance(attr_node, ast.Attribute):
                return attr_node.attr, t
            return node.attr, t
    return None


class LockClassInfo(NamedTuple):
    path: str
    name: str
    line: int
    locks: Dict[str, str]
    guarded: set
    acquiring: Dict[str, set]
    calls_under_lock: List[Tuple[frozenset, str, bool, int, int]]


_LOCK_INIT_METHODS = ("__init__", "__new__", "__post_init__")


def _with_locks_of(w: ast.With, locks) -> set:
    held = set()
    for item in w.items:
        e = item.context_expr
        if isinstance(e, ast.Attribute) and \
                isinstance(e.value, ast.Name) and \
                e.value.id == "self" and e.attr in locks:
            held.add(e.attr)
    return held


def _lock_class_scan(idx, cls: ast.ClassDef, findings: List[Finding]
                     ) -> Optional[LockClassInfo]:
    locks = _lock_attrs_of(cls)
    if not locks:
        return None
    info = LockClassInfo(idx.path, cls.name, cls.lineno, locks, set(),
                         {}, [])
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    def own_exprs(s):
        if isinstance(s, (ast.If, ast.While)):
            yield s.test
        elif isinstance(s, ast.For):
            yield s.iter
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef, ast.Try)):
            return
        else:
            yield s

    def _record_calls(expr, held: frozenset):
        if not held:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                recv = node.func.value
                info.calls_under_lock.append(
                    (frozenset(held), node.func.attr,
                     isinstance(recv, ast.Name) and recv.id == "self",
                     node.lineno, node.col_offset))

    def scan_writes(stmts, held: frozenset, report: bool, method: str):
        for s in stmts:
            if isinstance(s, ast.With):
                got = _with_locks_of(s, locks)
                if got:
                    info.acquiring.setdefault(method, set()).update(got)
                for item in s.items:
                    _record_calls(item.context_expr, held)
                scan_writes(s.body, held | frozenset(got), report, method)
                continue
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan_writes(s.body, frozenset(), report, method)
                continue
            if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                              ast.Delete)):
                targets = (s.targets if isinstance(
                    s, (ast.Assign, ast.Delete)) else [s.target])
                flat = []
                for t in targets:
                    if isinstance(t, (ast.Tuple, ast.List)):
                        flat.extend(t.elts)
                    else:
                        flat.append(t)
                for t in flat:
                    hit = _self_attr_of_store(t)
                    if hit is None or hit[0] in locks:
                        continue
                    if held:
                        info.guarded.add(hit[0])
                    elif report:
                        findings.append(Finding(
                            idx.path, t.lineno, t.col_offset,
                            "lock-discipline",
                            f"'self.{hit[0]}' mutated outside 'with "
                            f"self.<lock>' in lock-owning class "
                            f"'{cls.name}'"))
            for e in own_exprs(s):
                _record_calls(e, held)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(s, attr, None)
                if sub:
                    scan_writes(sub, held, report, method)
            for h in getattr(s, "handlers", ()):
                scan_writes(h.body, held, report, method)

    for node in methods:
        scan_writes(node.body, frozenset(),
                    node.name not in _LOCK_INIT_METHODS, node.name)

    def guarded_read_in(test, in_lock: bool, method: str):
        if in_lock:
            return
        for node in ast.walk(test):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Load) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self" and \
                    node.attr in info.guarded:
                findings.append(Finding(
                    idx.path, node.lineno, node.col_offset,
                    "lock-guard-read",
                    f"'self.{node.attr}' is written under a lock of "
                    f"'{cls.name}' but read in a branch test outside "
                    f"it (in '{method}') — check-then-act: take the "
                    f"same lock that writes the flag"))

    def scan_reads(stmts, in_lock: bool, method: str):
        for s in stmts:
            if isinstance(s, ast.With):
                held = _with_locks_of(s, locks)
                scan_reads(s.body, in_lock or bool(held), method)
                continue
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan_reads(s.body, False, method)
                continue
            if isinstance(s, (ast.If, ast.While)):
                guarded_read_in(s.test, in_lock, method)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(s, attr, None)
                if sub:
                    scan_reads(sub, in_lock, method)
            for h in getattr(s, "handlers", ()):
                scan_reads(h.body, in_lock, method)

    for node in methods:
        if node.name in _LOCK_INIT_METHODS:
            continue
        scan_reads(node.body, False, node.name)
    return info


_ORDER_DENY = frozenset((
    "get", "set", "put", "pop", "popleft", "popitem", "append",
    "appendleft", "add", "remove", "discard", "clear", "update",
    "extend", "insert", "keys", "values", "items", "setdefault",
    "move_to_end", "join", "start", "acquire", "release", "wait",
    "notify", "notify_all", "count", "index", "copy", "sort",
    "split", "strip", "format", "encode", "decode", "close",
))


def _lock_order_findings(infos: Sequence[LockClassInfo]
                         ) -> List[Finding]:
    findings: List[Finding] = []
    acquirers: Dict[str, List[str]] = {}
    for i in infos:
        for meth, lks in i.acquiring.items():
            if lks:
                acquirers.setdefault(meth, []).append(i.name)
    edges: Dict[str, set] = {}
    edge_at: Dict[Tuple[str, str], Tuple[str, int, int]] = {}
    for i in infos:
        for held, callee, is_self, line, col in i.calls_under_lock:
            if is_self:
                re_acq = held & i.acquiring.get(callee, set())
                bad = sorted(lk for lk in re_acq
                             if i.locks.get(lk) == "Lock")
                if bad:
                    findings.append(Finding(
                        i.path, line, col, "lock-order",
                        f"'{i.name}.{callee}' re-acquires the non-"
                        f"reentrant Lock 'self.{bad[0]}' the caller "
                        f"already holds — self-deadlock (use an "
                        f"_unlocked helper or an RLock)"))
                continue
            if callee in _ORDER_DENY:
                continue
            for target in acquirers.get(callee, ()):
                if target == i.name:
                    continue
                edges.setdefault(i.name, set()).add(target)
                edge_at.setdefault((i.name, target), (i.path, line, col))
    seen_cycles: set = set()
    for start in sorted(edges):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(edges.get(node, ())):
                if nxt == start:
                    cyc = tuple(sorted(path))
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    where = edge_at[(node, start)]
                    chain = " -> ".join(path + [start])
                    findings.append(Finding(
                        where[0], where[1], where[2], "lock-order",
                        f"lock-acquisition cycle across classes: "
                        f"{chain} — two threads entering from "
                        f"different ends deadlock; impose one global "
                        f"order or drop a lock from the chain"))
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return findings


def lock_lint_sources(srcs: Dict[str, str]
                      ) -> Tuple[List[Finding], dict]:
    """Plane ``lock`` over ``{path: source}`` → ``(raw findings,
    inventory)``; pragmas are the caller's job."""
    findings: List[Finding] = []
    infos: List[LockClassInfo] = []
    for path, src in sorted(srcs.items()):
        try:
            idx = ModuleIndex(path, src)
        except SyntaxError:
            continue
        for node in idx.tree.body:
            if isinstance(node, ast.ClassDef):
                info = _lock_class_scan(idx, node, findings)
                if info is not None:
                    infos.append(info)
    findings.extend(_lock_order_findings(infos))
    inventory = {
        "classes": len(infos),
        "locks": sum(len(i.locks) for i in infos),
        "guarded_attrs": sum(len(i.guarded) for i in infos),
        "class_names": sorted(i.name for i in infos),
        "detail": {i.name: {"locks": dict(i.locks),
                            "guarded": sorted(i.guarded)}
                   for i in infos},
    }
    return findings, inventory


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

def default_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _iter_files(root: str, extras: bool = True) -> List[str]:
    files = []
    pkg = os.path.join(root, PKG)
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                files.append(os.path.join(dirpath, fn))
    if extras:
        for extra in EXTRA_FILES:
            p = os.path.join(root, extra)
            if os.path.exists(p):
                files.append(p)
    return files


def _read_tree(root: str, extras: bool = True) -> Dict[str, str]:
    srcs: Dict[str, str] = {}
    for path in _iter_files(root, extras):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            srcs[rel] = f.read()
    return srcs


def run_plane_lock(root: str, raw_sink: Optional[List[Finding]] = None,
                   srcs: Optional[Dict[str, str]] = None
                   ) -> Tuple[List[Finding], dict]:
    """Package-wide lock plane, pragmas applied per file."""
    srcs = srcs if srcs is not None else _read_tree(root, extras=False)
    pkg_srcs = {p: s for p, s in srcs.items() if p.startswith(PKG + "/")}
    findings, inventory = lock_lint_sources(pkg_srcs)
    return suppress_by_source(root, findings,
                              raw_sink=raw_sink), inventory


def lint_sources(srcs: Dict[str, str], ledger_src: Optional[str] = None,
                 raw_sink: Optional[List[Finding]] = None,
                 sync_loops: Optional[bool] = None,
                 lock_rules: bool = False,
                 ledger_path: str = LEDGER_PATH) -> List[Finding]:
    """Plane ``ast`` over ``{path: source}`` (the tree, or fixtures):
    pragmas are parsed per file and applied; ``raw_sink`` receives the
    pre-suppression findings.  ``sync_loops`` forces the sync rule on
    (or off) for every file; by default it follows the path."""
    findings: List[Finding] = []
    indices: List[ModuleIndex] = []
    pragmas: Dict[str, Dict[int, set]] = {}
    for path, src in sorted(srcs.items()):
        pr, bad = parse_pragmas(src, path)
        pragmas[path] = pr
        findings.extend(bad)
        try:
            indices.append(ModuleIndex(path, src))
        except SyntaxError as e:
            findings.append(Finding(path, e.lineno or 1, 0, "bad-pragma",
                                    f"file does not parse: {e.msg}"))
    pkg = PackageIndex(indices)
    by_path: Dict[str, List[Finding]] = {}
    reached, blocks = captured_functions(pkg)
    _lint_captured(pkg, by_path, reached, blocks)
    sx = SyncIndex(pkg)
    keyed = key_positions(pkg)
    table = _donation_table(ledger_src, pkg) if ledger_src else {}
    for idx in indices:
        fs = by_path.setdefault(idx.path, [])
        norm = idx.path.replace(os.sep, "/")
        on = sync_loops if sync_loops is not None else any(
            norm.startswith(p) for p in SYNC_LOOP_PREFIXES)
        if on:
            _lint_sync_in_loop(idx, pkg, sx, fs)
        _lint_unhashable_static(idx, pkg, keyed, fs)
        _lint_donated_reuse(idx, pkg, table, fs)
        if lock_rules:
            _lint_lock_discipline(idx, fs)
    if ledger_src is not None:
        for f in check_registry(ledger_src, pkg, ledger_path):
            by_path.setdefault(f.path, []).append(f)
    out: List[Finding] = []
    for path, fs in by_path.items():
        seen, uniq = set(), []
        for f in sorted(fs, key=lambda f: (f.line, f.col, f.rule)):
            key = (f.line, f.rule, f.msg)
            if key not in seen:
                seen.add(key)
                uniq.append(f)
        if raw_sink is not None:
            raw_sink.extend(uniq)
        if path in pragmas:
            uniq = apply_pragmas(uniq, pragmas[path])
        out.extend(uniq)
    return sorted(findings + out,
                  key=lambda f: (f.path, f.line, f.col, f.rule))


def run_plane_ast(root: str, raw_sink: Optional[List[Finding]] = None,
                  srcs: Optional[Dict[str, str]] = None
                  ) -> List[Finding]:
    """Plane ``ast`` over the package (the bad-pragma check also over
    ``chip_smoke.py``)."""
    srcs = srcs if srcs is not None else _read_tree(root)
    pkg_srcs = {p: s for p, s in srcs.items() if p.startswith(PKG + "/")}
    findings = lint_sources(pkg_srcs, ledger_src=pkg_srcs.get(LEDGER_PATH),
                            raw_sink=raw_sink)
    for path, src in srcs.items():
        if path not in pkg_srcs:
            findings.extend(parse_pragmas(src, path)[1])
    return findings


# ---------------------------------------------------------------------------
# the runtime planes: the canonical workload and its observer
# ---------------------------------------------------------------------------

# Round-loop entry points: no device/host copy or scalar readback inside.
ROUND_LOOP = ("swarm.lookup_step", "swarm.traced_lookup_step",
              "swarm.chaos_lookup_step", "serve._resident_core",
              "sharded.sharded_lookup_step",
              "sharded._sharded_resident_step")

N_NODES = 2048
N_TARGETS = 512
# Rows only the card reaches: a CUDA-graph replay (the CPU engines run
# the macro step eagerly).
CARD_ONLY = ("serve._resident_replay",)


def _port_frame(root: str, skip_tools: bool = True):
    """(repo-relative path, line) of the innermost frame in the port's
    package (outside ``tools/``), or None."""
    f = sys._getframe(1)
    root = os.path.abspath(root)
    pkg_dir = os.path.join(root, PKG) + os.sep
    tools = os.path.join(root, PKG, "tools") + os.sep
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(pkg_dir) and not (skip_tools and
                                           fn.startswith(tools)):
            return os.path.relpath(fn, root).replace(os.sep, "/"), \
                f.f_lineno
        f = f.f_back
    return None


def _tensor_leaves(x, out=None):
    import torch
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for e in x:
            _tensor_leaves(e, out)
    elif isinstance(x, dict):
        for e in x.values():
            _tensor_leaves(e, out)
    return out


def _make_observer_mode():
    """A ``TorchDispatchMode`` class that hands every op to its
    ``hooks`` (built lazily: the module imports no torch)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Observer(TorchDispatchMode):
        def __init__(self, hooks):
            super().__init__()
            self.hooks = hooks

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            for h in self.hooks:
                if h.pre is not None:
                    h.pre(func, args, kwargs)
            out = func(*args, **kwargs)
            for h in self.hooks:
                h.post(func, args, kwargs, out)
            return out

    return Observer


class _Hook:
    pre = None

    def post(self, func, args, kwargs, out):
        raise NotImplementedError


_COPY_OPS = ("aten._to_copy.default", "aten.copy_.default",
             "aten._copy_from.default", "aten._copy_from_and_resize.default")


class LowerHook(_Hook):
    """f64 tensors made inside an entry point; device/host copies and
    scalar readbacks inside a round-loop entry point."""

    def __init__(self, root: str, stack: list):
        self.root, self.stack = root, stack
        self.findings: List[Finding] = []
        self._seen: set = set()

    def _emit(self, rule, msg):
        where = _port_frame(self.root) or (LEDGER_PATH, 1)
        key = (where, rule)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(where[0], where[1], 0, rule, msg))

    def post(self, func, args, kwargs, out):
        import torch
        if not self.stack:
            return
        name = str(func)
        entry = self.stack[-1]
        for t in _tensor_leaves(out):
            if t.dtype == torch.float64:
                self._emit("f64-leak",
                           f"{entry}: '{name}' made a float64 tensor")
                break
        if not any(e in ROUND_LOOP for e in self.stack):
            return
        if name == "aten._local_scalar_dense.default":
            self._emit("host-callback",
                       f"{entry}: a scalar read back to the host "
                       f"(_local_scalar_dense) inside a round-loop entry")
            return
        if name in _COPY_OPS:
            devs = {t.device.type for t in
                    _tensor_leaves(list(args)) + _tensor_leaves(out)}
            if len(devs) > 1:
                self._emit("host-callback",
                           f"{entry}: '{name}' copies between "
                           f"{' and '.join(sorted(devs))} inside a "
                           f"round-loop entry")


def _entry_name(mod_name: str, attr: str) -> str:
    return f"{mod_name.rsplit('.', 1)[-1]}.{attr}"


class LintLedger:
    """The cost ledger's instrumentation with a lint observer per entry
    call: the call count, the ``_version`` of every tensor argument
    before and after, a stack of active entries for the dispatch hooks,
    and the first call's entry frame for the interval prover."""

    def __init__(self, device):
        from ..obs.ledger import CostLedger

        lint = self
        self.stack: List[str] = []
        self.calls: Dict[str, int] = {}
        self.moved: Dict[str, set] = {}       # entry → positions written
        self.still: Dict[str, set] = {}       # entry → declared, unmoved
        self.on_enter = []                # callbacks(entry, fn, args, kw)
        self.on_exit = []
        self._params: Dict[object, List[str]] = {}

        class _Ledger(CostLedger):
            def _wrap(self, name, fn, donate, barrier):
                import functools

                @functools.wraps(fn)
                def observed(*args, **kwargs):
                    return lint._observe(name, fn, tuple(donate), args,
                                         kwargs)
                return super()._wrap(name, observed, donate, barrier)

        self.ledger = _Ledger(device=device)

    def _positions(self, fn, kwargs) -> List[Tuple[int, object]]:
        """``(position, value)`` of each keyword argument."""
        import inspect
        if not kwargs:
            return []
        names = self._params.get(fn)
        if names is None:
            try:
                names = list(inspect.signature(fn).parameters)
            except (TypeError, ValueError):
                names = []
            self._params[fn] = names
        return [(names.index(k), v) for k, v in kwargs.items()
                if k in names]

    def _observe(self, name, fn, donate, args, kwargs):
        given = list(enumerate(args)) + self._positions(fn, kwargs)
        before = [(i, [(t, t._version) for t in _tensor_leaves(a)])
                  for i, a in given]
        self.calls[name] = self.calls.get(name, 0) + 1
        self.stack.append(name)
        for cb in self.on_enter:
            cb(name, fn, args, kwargs)
        try:
            out = fn(*args, **kwargs)
        finally:
            self.stack.pop()
            for cb in self.on_exit:
                cb(name)
        for i, leaves in before:
            moved = any(t._version != v for t, v in leaves)
            if moved:
                self.moved.setdefault(name, set()).add(i)
            elif i in donate and leaves:
                self.still.setdefault(name, set()).add(i)
        for i in donate:
            if i in self.moved.get(name, ()):
                self.still.get(name, set()).discard(i)
        return out

    @contextlib.contextmanager
    def instrument(self):
        with self.ledger.instrument():
            yield self


def _open_mesh(device):
    """A one-rank mesh over a file store in a fresh temporary
    directory: NCCL on the card (graphs capture its collectives), gloo
    on the CPU."""
    import tempfile

    import torch

    from ..parallel.mesh import make_mesh
    d = tempfile.mkdtemp(prefix="graftlint-mesh-")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    return make_mesh(1, 0, backend=backend, device=device,
                     init_method=f"file://{d}/store"), d


def build_workloads(device, n_nodes: int = N_NODES,
                    n_targets: int = N_TARGETS) -> Dict[str, object]:
    """The canonical workloads (JAX's, in the port's spelling), reaching
    every ``ENTRY_POINTS`` row on ``device``."""
    import numpy as np
    import torch

    from ..models import serve as sv
    from ..models import storage as stg
    from ..models import swarm as sw

    dev = torch.device(device)
    cfg = sw.SwarmConfig.for_nodes(n_nodes, device=dev)
    g = torch.Generator(device=dev)
    swarm = sw.build_swarm(cfg, g.manual_seed(7), device=dev)
    targets = torch.randint(0, 2**32, (n_targets, 5),
                            generator=g.manual_seed(1), device=dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def ar(n):
        return torch.arange(n, device=dev)

    def local_engines():
        sw.lookup(swarm, cfg, targets, gen(2), compact=True, device=dev)
        sw.lookup(swarm, cfg, targets, gen(2), compact=False, device=dev)
        sw.traced_lookup(swarm, cfg, targets, gen(2), compact=True,
                         device=dev)
        sw.traced_lookup(swarm, cfg, targets, gen(2), compact=False,
                         device=dev)
        bz = sw.corrupt_swarm(swarm, gen(3), 0.10, cfg)
        f = sw.LookupFaults(drop_frac=0.15, seed=6)
        sw.chaos_lookup(bz, cfg, targets, gen(2), f, compact=True,
                        device=dev)
        sw.chaos_lookup(bz, cfg, targets, gen(2), f, compact=False,
                        collect_trace=True, device=dev)

    def fresh_state():
        o = sw._sample_origins(gen(2), swarm.alive, n_targets)
        return sw.lookup_init(swarm, cfg, targets, o), \
            ar(n_targets)

    def compaction_plumbing():
        st, order = fresh_state()
        full, order2, sub = sw._compact_slice(st, order, n_targets // 2)
        full2, _o3, sub2 = sw._compact_resize(full, order2, sub,
                                              n_targets // 4)
        sw._writeback_prefix(full2, sub2)
        st2, order_b = fresh_state()
        sw._finalize(swarm.ids, st2, cfg)
        sw._finalize_scattered(swarm.ids, st2, order_b, cfg)
        st3, _ = fresh_state()
        sw._evict_blacklisted(
            st3, torch.zeros((cfg.n_nodes,), dtype=torch.bool, device=dev),
            cfg)

    def serve_engine():
        sv.closed_loop_replay(swarm, cfg, targets[:256], gen(2),
                              device=dev)
        eng = sv.ServeEngine(swarm, cfg, slots=256, admit_cap=128,
                             device=dev)
        st = eng.empty()
        o = sw._sample_origins(gen(4), swarm.alive, 128)
        st = eng.admit(st, targets[:128], ar(128), o, 0)
        st = eng.step(st, 1)
        eng.snapshot(st)
        st = eng.expire(st, ar(128))
        eng_c = sv.ServeEngine(swarm, cfg, slots=256, admit_cap=128,
                               cache_slots=256, device=dev)
        stc = eng_c.empty()
        eng_c.admit_probed(stc, targets[:128], ar(128), o, 0)
        eng_c.fill_cache(targets[:8].cpu().numpy(),
                         np.full((8, cfg.quorum), -1, np.int32),
                         np.zeros((8,), np.int32), 1)
        eng_c.probe_cache(targets[:128])
        eng_c.invalidate_cache()

    def resident_engine():
        sv.resident_closed_loop_replay(swarm, cfg, targets[:256], gen(2),
                                       device=dev)
        for kw in ({}, {"cache_slots": 256}, {"rung_block": 8}):
            eng = sv.ResidentServeEngine(swarm, cfg, slots=256,
                                         admit_cap=128, ring_slots=512,
                                         device=dev, **kw)
            o = sw._sample_origins(gen(5), swarm.alive, 128)
            _st, _rings, out = eng.macro_step(
                eng.empty(), eng.empty_rings(), targets[:128], ar(128),
                torch.zeros((128,), dtype=torch.int32, device=dev), o,
                128, 0)
            eng.read_out(out)

    def storage_paths():
        scfg = stg.StoreConfig(slots=4, listen_slots=2, max_listeners=64,
                               payload_words=2)
        store = stg.empty_store(cfg.n_nodes, scfg, device=dev)
        keys = torch.randint(0, 2**32, (64, 5), generator=gen(5),
                             device=dev)
        vals = ar(64) + 1
        seqs = torch.ones((64,), dtype=torch.int64, device=dev)
        pls = torch.randint(0, 2**32, (64, 2), generator=gen(6),
                            device=dev)
        store, _ = stg.announce(swarm, cfg, store, scfg, keys, vals, seqs,
                                0, gen(8), payloads=pls, device=dev)
        stg.get_values(swarm, cfg, store, scfg, keys, gen(9), device=dev)
        stg.listen_at(swarm, cfg, store, scfg, keys[:8], ar(8), gen(10),
                      0, device=dev)
        m = 32
        z = torch.zeros((m,), dtype=torch.int64, device=dev)
        stg._store_insert(store, scfg, ar(m), keys[:m], vals[:m],
                          seqs[:m], ar(m), 0, z + 1, z, pls[:m])

    def integrity_plane():
        from ..models import integrity as ig
        from ..ops.sha1 import sha1_blocks, sha1_pad_blocks
        scfg_v = stg.StoreConfig(slots=4, listen_slots=2, max_listeners=64,
                                 payload_words=2, verify=True)
        store_v = stg.empty_store(cfg.n_nodes, scfg_v, device=dev)
        pls = torch.randint(0, 2**32, (64, 2), generator=gen(31),
                            device=dev)
        ckeys = ig.content_ids(pls)
        store_v, _ = stg.announce(
            swarm, cfg, store_v, scfg_v, ckeys, ar(64) + 1,
            torch.ones((64,), dtype=torch.int64, device=dev), 0, gen(32),
            payloads=pls, device=dev)
        stg.get_values(swarm, cfg, store_v, scfg_v, ckeys, gen(33),
                       device=dev)
        blocks, n_blocks = sha1_pad_blocks(
            torch.zeros((4, 20), dtype=torch.int64, device=dev),
            torch.tensor([0, 55, 56, 64], dtype=torch.int32, device=dev))
        sha1_blocks(blocks, n_blocks)

    def chunked_plane():
        from ..models import chunked_values as cv
        pls = torch.randint(0, 2**32, (64, 4, 2), generator=gen(41),
                            device=dev)
        lens = torch.randint(0, 33, (64,), generator=gen(42), device=dev)
        ckeys = cv.chunked_content_ids(pls, lens)
        cv._chunked_root_ok(ckeys, pls, lens)

    def index_kernels():
        from ..models import index as ix
        from ..ops.sha1 import sha1_one_block, sha1_pad_le55
        spec = ix.IndexSpec.from_key_spec("lint", {"id": 4})
        fb, fl = ix.fields_to_arrays(spec, [{"id": b"ab"}, {"id": b"cd"}])
        bits = ix._linearize_batch(
            spec, torch.from_numpy(fb.astype(np.int64)).to(dev),
            torch.from_numpy(fl.astype(np.int64)).to(dev))
        ix._trie_node_hash(spec, bits, torch.zeros(
            (2,), dtype=torch.int32, device=dev))
        ix._pack_entry_payloads(
            spec, torch.zeros((2, 5), dtype=torch.int64, device=dev),
            ar(2), bits)
        sha1_one_block(sha1_pad_le55(
            torch.zeros((2, 3), dtype=torch.int64, device=dev),
            torch.full((2,), 9, dtype=torch.int32, device=dev)))

    def monitor_sweep():
        from ..models import monitor as mon
        mon.MonitorEngine(swarm, cfg, device=dev).sweep(gen(11))

    def soak_engine():
        from ..models import soak as sk
        c, a = 256, 128
        eng = sk.SoakEngine(swarm, cfg, slots=c, admit_cap=a, device=dev)
        o = sw._sample_origins(gen(12), swarm.alive, a)
        st = eng.serve.empty()
        st, *_ = eng.admit_serve(st, targets[:a], ar(a),
                                 np.zeros(a, np.int32), o, 0)
        eng_c = sk.SoakEngine(swarm, cfg, slots=c, admit_cap=a,
                              cache_slots=128, device=dev)
        eng_c.admit_serve(eng_c.serve.empty(), targets[:a], ar(a),
                          np.zeros(a, np.int32), o, 0)
        pool = torch.randint(0, 2**32, (64, 5), generator=gen(21),
                             device=dev)
        wc = torch.zeros((c,), dtype=torch.int32, device=dev)
        st, _wc = sk._admit_maintenance(
            swarm, cfg, st, wc, pool, ar(a) % 64,
            torch.full((a,), c, dtype=torch.int64, device=dev),
            sw._sample_origins(gen(22), swarm.alive, a), 0, sk.WC_REPUB)
        rings = sv.empty_serve_rings(c, 4 * a, device=dev)
        sk._ring_enqueue_maintenance(rings, pool, ar(a) % 64, a,
                                     sk.WC_REPUB)
        buf = torch.full((64, cfg.quorum), -1, dtype=torch.int32,
                         device=dev)
        sk._fold_completed(buf, swarm.ids, st, cfg,
                           torch.zeros((a,), dtype=torch.int64, device=dev),
                           torch.full((a,), 64, dtype=torch.int64,
                                      device=dev))
        scfg_s = stg.StoreConfig(slots=4, listen_slots=2, max_listeners=64,
                                 payload_words=0)
        store_s = stg.empty_store(cfg.n_nodes, scfg_s, device=dev)
        z = torch.zeros((64,), dtype=torch.int64, device=dev)
        sk._repub_insert_completed(
            swarm.ids, swarm.alive, cfg, scfg_s, store_s, st,
            torch.zeros((a,), dtype=torch.int64, device=dev),
            torch.full((a,), 64, dtype=torch.int64, device=dev),
            torch.zeros((64, 5), dtype=torch.int64, device=dev), z, z, z, z,
            torch.zeros((64, 0), dtype=torch.int64, device=dev),
            torch.zeros((64,), dtype=torch.bool, device=dev),
            torch.tensor([0, 0, 2**30], dtype=torch.int32, device=dev), 0)
        sk._scatter_wclass(wc, ar(a), 2)
        sk._soak_snapshot(swarm, cfg, st, wc)

    def sharded_engines():
        import shutil

        from ..parallel import sharded as sh
        from ..parallel import sharded_storage as shst
        mesh, tmp = _open_mesh(dev)
        try:
            for compact, rebalance in ((True, False), (True, True),
                                       (False, False)):
                sh.sharded_lookup(swarm, cfg, targets, mesh, gen(2),
                                  compact=compact, rebalance=rebalance)
            eng = sv.ShardedResidentServeEngine(
                swarm, cfg, 256, mesh, admit_cap=256, ring_slots=512,
                cache_slots=256)
            o = sw._sample_origins(gen(13), swarm.alive, 256)
            _st, _rings, out = eng.macro_step(
                eng.empty(), eng.empty_rings(), targets[:256], ar(256),
                torch.zeros((256,), dtype=torch.int32, device=dev), o,
                256, 0)
            eng.read_out(out)
            scfg8 = stg.StoreConfig(slots=4, listen_slots=2,
                                    max_listeners=64, payload_words=2)
            store8 = shst.sharded_empty_store(cfg.n_nodes, scfg8, mesh)
            shst.sharded_announce(
                swarm, cfg, store8, scfg8, targets[:256], ar(256) + 1,
                torch.ones((256,), dtype=torch.int64, device=dev), 0, mesh,
                gen(12), payloads=torch.randint(
                    0, 2**32, (256, 2), generator=gen(14), device=dev))
        finally:
            mesh.close()
            shutil.rmtree(tmp, ignore_errors=True)

    return {
        "local-engines": local_engines,
        "compaction-plumbing": compaction_plumbing,
        "serve-engine": serve_engine,
        "resident-engine": resident_engine,
        "soak-engine": soak_engine,
        "storage-paths": storage_paths,
        "integrity-plane": integrity_plane,
        "chunked-plane": chunked_plane,
        "index-kernels": index_kernels,
        "monitor-sweep": monitor_sweep,
        "sharded-engines": sharded_engines,
    }


class LintRun(NamedTuple):
    """One canonical-workload pass: the observer's records and what the
    dispatch hooks found."""
    device: str
    lint: "LintLedger"
    lower: List[Finding]
    ranges: List[Finding]
    range_stats: dict
    workload_findings: List[Finding]
    seconds: float


_RUNS: Dict[Tuple[str, bool], LintRun] = {}


def recorded_run(root: str, device="cuda", ranges: bool = False
                 ) -> LintRun:
    """Run every canonical workload once on ``device`` under the lint
    ledger and the dispatch observer (with the interval prover on the
    first call of each entry when ``ranges``), memoized per process."""
    import torch

    key = (str(torch.device(device)), ranges)
    if key in _RUNS:
        return _RUNS[key]
    t0 = time.perf_counter()
    lint = LintLedger(device)
    lower = LowerHook(root, lint.stack)
    hooks = [lower]
    prover = None
    if ranges:
        from .graftlint_ranges import RangeHook
        prover = RangeHook(root, lint)
        hooks.append(prover)
    mode = _make_observer_mode()(hooks)
    wf: List[Finding] = []
    with lint.instrument(), mode:
        for name, fn in build_workloads(device).items():
            try:
                fn()
            except Exception as e:
                wf.append(Finding(
                    LEDGER_PATH, 1, 0, "unexercised-entry",
                    f"canonical workload '{name}' raised "
                    f"{type(e).__name__}: {e} — the entry points it "
                    f"exercises stay unverified"))
    run = LintRun(key[0], lint, lower.findings,
                  prover.findings if prover else [],
                  prover.stats() if prover else {}, wf,
                  time.perf_counter() - t0)
    _RUNS[key] = run
    return run


def lower_findings(run: LintRun, ledger_src: str) -> List[Finding]:
    """The ``lower`` rules from one recorded run."""
    rows = parse_entry_points(ledger_src)
    ep = _entry_points_line(ledger_src)
    findings = list(run.workload_findings) + list(run.lower)
    for mod, attr, donate, _b in rows:
        name = _entry_name(mod, attr)
        calls = run.lint.calls.get(name, 0)
        if calls == 0 and run.device == "cpu" and name in CARD_ONLY:
            continue
        if calls == 0:
            findings.append(Finding(
                LEDGER_PATH, ep, 0, "unexercised-entry",
                f"{name}: the canonical workload never called it, so its "
                f"in-place / f64 / readback invariants are unverified"))
            continue
        moved = run.lint.moved.get(name, set())
        for i in sorted(run.lint.still.get(name, set())):
            findings.append(Finding(
                LEDGER_PATH, ep, 0, "donation-drop",
                f"{name}: argument {i} is declared overwritten in place, "
                f"but no call changed its tensors' _version"))
        for i in sorted(moved - set(donate)):
            findings.append(Finding(
                LEDGER_PATH, ep, 0, "registry-drift",
                f"{name}: argument {i} was written in place (its "
                f"_version moved) but the row lists {tuple(donate)}"))
    return findings


def run_plane_lower(root: str, device="cuda", ranges: bool = False
                    ) -> List[Finding]:
    run = recorded_run(root, device, ranges)
    with open(os.path.join(root, LEDGER_PATH), encoding="utf-8") as f:
        src = f.read()
    return suppress_by_source(root, lower_findings(run, src))


# ---------------------------------------------------------------------------
# plane strict
# ---------------------------------------------------------------------------

_ELEMENTWISE = {
    "add", "sub", "mul", "div", "remainder", "fmod", "floor_divide",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
    "bitwise_right_shift", "__lshift__", "__rshift__", "eq", "ne", "lt",
    "le", "gt", "ge", "maximum", "minimum", "logical_and", "logical_or",
    "logical_xor", "where", "pow", "atan2", "fmax", "fmin"}


class StrictHook(_Hook):
    """Rank promotion and NaN, for the CPU replay."""

    def __init__(self, root: str):
        self.root = root
        self.findings: List[Finding] = []
        self._seen: set = set()
        self.active = False

    def _emit(self, msg):
        where = _port_frame(self.root) or (PKG, 1)
        key = (where, msg.split(":")[0])
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(where[0], where[1], 0,
                                     "strict-replay", msg))

    def post(self, func, args, kwargs, out):
        import torch
        if not self.active:
            return
        op = func.overloadpacket.__name__.rstrip("_")
        if op in _ELEMENTWISE:
            ts = [a for a in args if isinstance(a, torch.Tensor)
                  and a.dim() > 0]
            if len({t.dim() for t in ts}) > 1:
                self._emit(f"rank promotion in '{func}': operands of "
                           f"{sorted(t.dim() for t in ts)} dims broadcast "
                           f"implicitly")
        for t in _tensor_leaves(out):
            if t.is_floating_point() and t.numel() and \
                    bool(torch.isnan(t).any()):
                self._emit(f"NaN in the output of '{func}'")
                break


def strict_workloads(device, n_nodes: int = N_NODES):
    """JAX's seven strict workloads and the resident open loop:
    ``(name, fn)`` with their inputs made outside (setup is not
    replayed)."""
    import torch

    from ..models import serve as sv
    from ..models import storage as stg
    from ..models import swarm as sw

    dev = torch.device(device)
    cfg = sw.SwarmConfig.for_nodes(n_nodes, device=dev)
    g = torch.Generator(device=dev)
    swarm = sw.build_swarm(cfg, g.manual_seed(7), device=dev)
    targets = torch.randint(0, 2**32, (N_TARGETS, 5),
                            generator=g.manual_seed(1), device=dev)
    bz = sw.corrupt_swarm(swarm, g.manual_seed(3), 0.10, cfg)
    faults = sw.LookupFaults(drop_frac=0.15, seed=6)
    scfg = stg.StoreConfig(slots=4, listen_slots=2, max_listeners=64,
                           payload_words=2)
    store0 = stg.empty_store(cfg.n_nodes, scfg, device=dev)
    skeys = torch.randint(0, 2**32, (64, 5), generator=g.manual_seed(5),
                          device=dev)
    svals = torch.arange(64, device=dev) + 1
    sseqs = torch.ones((64,), dtype=torch.int64, device=dev)
    lregs = torch.arange(8, device=dev)
    ridx = torch.arange(16, device=dev)
    t256 = targets[:256].clone()
    ev_ts, ev_keys, ev_cls = sv.poisson_zipf_events(2000.0, 0.25, 512, 1.1,
                                                    seed=7)
    resident = sv.ResidentServeEngine(swarm, cfg, slots=256, admit_cap=128,
                                      device=dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def storage():
        store = type(store0)(*[t.clone() for t in store0])
        store, _ = stg.announce(swarm, cfg, store, scfg, skeys, svals,
                                sseqs, 0, gen(8), device=dev)
        stg.get_values(swarm, cfg, store, scfg, skeys, gen(9), device=dev)
        stg.listen_at(swarm, cfg, store, scfg, skeys[:8], lregs, gen(10),
                      0, device=dev)
        stg.republish_from(swarm, cfg, store, scfg, ridx, 1, gen(11),
                           device=dev)

    return [
        ("lookup-compact", lambda: sw.lookup(
            swarm, cfg, targets, gen(2), compact=True, device=dev)),
        ("lookup-full-width", lambda: sw.lookup(
            swarm, cfg, targets, gen(2), compact=False, device=dev)),
        ("lookup-lifecycle", lambda: sw.lookup(
            swarm, cfg, targets, gen(2), compact=True, stats={},
            track_lifecycle=True, device=dev)),
        ("traced-lookup", lambda: sw.traced_lookup(
            swarm, cfg, targets, gen(2), compact=True, device=dev)),
        ("chaos-lookup", lambda: sw.chaos_lookup(
            bz, cfg, targets, gen(2), faults, compact=True, device=dev)),
        ("storage-announce-get", storage),
        ("serve-closed-loop", lambda: sv.closed_loop_replay(
            swarm, cfg, t256, gen(2), device=dev)),
        # Not one of JAX's seven: the resident loop's one readback a
        # macro step (its first call captures the graphs).
        ("resident-open-loop", lambda: sv.serve_resident(
            resident, ev_ts, ev_keys, gen(3), klass=ev_cls,
            duration=float(ev_ts[-1]) + 1e-9,
            host_orchestration_budget=1.0)),
    ]


class SyncSite(NamedTuple):
    path: str
    first: int           # the declared statement's lines
    last: int
    pragma: int


def declared_sync_sites(srcs: Dict[str, str]) -> List[SyncSite]:
    """Every statement a ``sync-in-loop`` pragma covers."""
    out = []
    for path, src in srcs.items():
        pragmas, _ = parse_pragmas(src, path)
        lines = [ln for ln, r in pragmas.items() if "sync-in-loop" in r]
        if not lines:
            continue
        tree = ast.parse(src)
        spans = []                     # (first, last) of each statement
        for n in ast.walk(tree):       # an if / while: its test alone
            if isinstance(n, (ast.If, ast.While)):
                spans.append((n.lineno, n.test.end_lineno))
            elif isinstance(n, ast.stmt) and not isinstance(
                    n, (ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef,
                        ast.For, ast.With, ast.Try)):
                spans.append((n.lineno, n.end_lineno))
        for ln in lines:
            for target in (ln, ln + 1):
                hit = [sp for sp in spans if sp[0] == target]
                if hit:
                    out.append(SyncSite(path, hit[0][0], hit[0][1], ln))
                    break
    return out


def loop_lines(srcs: Dict[str, str]) -> Dict[str, List[Tuple[int, int]]]:
    """Line spans of every host-loop body (and while test) in the
    engine modules."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    for path, src in srcs.items():
        if not any(path.startswith(p) for p in SYNC_LOOP_PREFIXES):
            continue
        for n in ast.walk(ast.parse(src)):
            if isinstance(n, (ast.For, ast.While)):
                first = (n.test.lineno if isinstance(n, ast.While)
                         else n.body[0].lineno)
                out.setdefault(path, []).append((first, n.end_lineno))
    return out


class SyncRecorder:
    """Synchronizing CUDA calls (``torch.cuda.set_sync_debug_mode
    ("warn")``) with the port frames of their stacks, and how often each
    declared site's statement ran (``sys.monitoring`` line events on the
    code objects holding them)."""

    TOOL = 4

    def __init__(self, root: str, sites: Sequence[SyncSite]):
        self.root = os.path.abspath(root)
        self.sites = list(sites)
        self.events: List[List[Tuple[str, int]]] = []
        self.runs: Dict[SyncSite, int] = {s: 0 for s in sites}
        self._codes = []

    def _showwarning(self, message, category, filename, lineno,
                     file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = []
        f = sys._getframe(1)
        pkg_dir = os.path.join(self.root, PKG) + os.sep
        tools = os.path.join(self.root, PKG, "tools") + os.sep
        while f is not None:
            fn = f.f_code.co_filename
            if fn.startswith(pkg_dir) and not fn.startswith(tools):
                frames.append((os.path.relpath(fn, self.root).replace(
                    os.sep, "/"), f.f_lineno))
            f = f.f_back
        self.events.append(frames)

    def _code_objects(self):
        import importlib
        import types
        out = []
        for s in self.sites:
            mod = importlib.import_module(_module_name_of(s.path))
            seen = set()
            stack = [v for v in vars(mod).values()
                     if isinstance(v, (types.FunctionType, type))]
            codes = []
            while stack:
                v = stack.pop()
                if id(v) in seen:
                    continue
                seen.add(id(v))
                if isinstance(v, type):
                    if v.__module__ == mod.__name__:
                        stack.extend(vars(v).values())
                    continue
                if isinstance(v, (staticmethod, classmethod)):
                    v = v.__func__
                if isinstance(v, property):
                    stack.extend(x for x in (v.fget, v.fset) if x)
                    continue
                code = getattr(v, "__code__", v if isinstance(
                    v, types.CodeType) else None)
                if code is None:
                    continue
                codes.append(code)
                stack.extend(c for c in code.co_consts
                             if isinstance(c, types.CodeType))
            want = os.path.abspath(os.path.join(self.root, s.path))
            for code in codes:        # a module's names may be imported
                if os.path.abspath(code.co_filename) == want and any(
                            ln is not None and s.first <= ln <= s.last
                            for _a, _b, ln in code.co_lines()):
                    out.append((code, s))
        return out

    @contextlib.contextmanager
    def record(self):
        import warnings

        import torch
        mon = sys.monitoring
        pairs = self._code_objects()
        by_code: Dict[object, List[SyncSite]] = {}
        for code, s in pairs:
            by_code.setdefault(code, []).append(s)

        last: Dict[object, int] = {}

        def on_line(code, line):
            # A statement spanning lines reports its first line again
            # after its later ones: a run is an entry from outside it.
            prev = last.get(code, 0)
            last[code] = line
            for s in by_code.get(code, ()):
                if line == s.first and not s.first <= prev <= s.last:
                    self.runs[s] += 1
            return None

        mon.use_tool_id(self.TOOL, "graftlint")
        try:
            mon.register_callback(self.TOOL, mon.events.LINE, on_line)
            for code in by_code:
                mon.set_local_events(self.TOOL, code, mon.events.LINE)
            card = torch.cuda.is_available()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = self._showwarning
                if card:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    yield self
                finally:
                    if card:
                        torch.cuda.set_sync_debug_mode(0)
        finally:
            for code in by_code:
                mon.set_local_events(self.TOOL, code, 0)
            mon.register_callback(self.TOOL, mon.events.LINE, None)
            mon.free_tool_id(self.TOOL)


def judge_syncs(events: Sequence[Sequence[Tuple[str, int]]],
                sites: Sequence[SyncSite],
                runs: Dict[SyncSite, int],
                loops: Dict[str, List[Tuple[int, int]]]
                ) -> Tuple[List[Finding], dict, int]:
    """Each sync made inside a host loop must come through a declared
    site (the innermost in-loop frame of its stack), at most once for
    each run of that site's statement.  Returns (findings, syncs by
    ``file:line`` of the site or of the sync, one-off syncs)."""
    findings: List[Finding] = []
    per_site: Dict[SyncSite, int] = {}
    by_line: Dict[str, int] = {}
    one_off = 0

    def in_loop(path, line):
        return any(a <= line <= b for a, b in loops.get(path, ()))

    for frames in events:
        where = frames[0] if frames else (PKG, 1)
        site = None
        looped = None
        for path, line in frames:           # innermost first
            for s in sites:
                if s.path == path and s.first <= line <= s.last:
                    site = s
                    break
            if site is not None:
                break
            if looped is None and in_loop(path, line):
                looped = (path, line)
        if site is not None:
            per_site[site] = per_site.get(site, 0) + 1
            k = f"{site.path}:{site.first}"
            by_line[k] = by_line.get(k, 0) + 1
            continue
        k = f"{where[0]}:{where[1]}"
        by_line[k] = by_line.get(k, 0) + 1
        if looped is not None:
            findings.append(Finding(
                looped[0], looped[1], 0, "strict-replay",
                f"a synchronizing CUDA call at {where[0]}:{where[1]} made "
                f"inside a host loop through no declared readback site"))
        else:
            one_off += 1
    for s, n in per_site.items():
        if n > runs.get(s, 0):
            findings.append(Finding(
                s.path, s.first, 0, "strict-replay",
                f"declared readback site synced {n} times over "
                f"{runs.get(s, 0)} runs of its statement — more than one "
                f"readback each time it runs"))
    return findings, dict(sorted(by_line.items())), one_off


def run_plane_strict(root: str, device="cuda",
                     srcs: Optional[Dict[str, str]] = None
                     ) -> Tuple[List[Finding], dict]:
    """The strict workloads, each warmed once and then replayed
    under the checks (the card: the sync contract; the CPU: rank
    promotion and NaN).  Returns (findings, stats)."""
    import torch

    dev = torch.device(device)
    srcs = srcs if srcs is not None else _read_tree(root, extras=False)
    findings: List[Finding] = []
    stats: dict = {"device": dev.type}
    try:
        workloads = strict_workloads(dev)
    except Exception as e:
        return [Finding(PKG, 1, 0, "strict-replay",
                        f"workload setup failed: {type(e).__name__}: "
                        f"{e}")], stats
    for _name, fn in workloads:                 # warm: builds, allocations
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        sites = declared_sync_sites(srcs)
        rec = SyncRecorder(root, sites)
        with rec.record():
            for name, fn in workloads:
                try:
                    fn()
                except Exception as e:
                    findings.append(Finding(
                        PKG, 1, 0, "strict-replay",
                        f"workload '{name}' failed: {type(e).__name__}: "
                        f"{str(e).splitlines()[0][:200]}"))
        torch.cuda.synchronize(dev)
        fs, by_line, one_off = judge_syncs(rec.events, sites, rec.runs,
                                           loop_lines(srcs))
        findings.extend(fs)
        stats.update({"syncs": len(rec.events), "sync_sites": by_line,
                      "one_off_syncs": one_off,
                      "site_runs": {f"{s.path}:{s.first}": n
                                    for s, n in rec.runs.items() if n}})
    else:
        hook = StrictHook(root)
        mode = _make_observer_mode()([hook])
        with mode:
            hook.active = True
            for name, fn in workloads:
                try:
                    fn()
                except Exception as e:
                    findings.append(Finding(
                        PKG, 1, 0, "strict-replay",
                        f"workload '{name}' failed: {type(e).__name__}: "
                        f"{str(e).splitlines()[0][:200]}"))
            hook.active = False
        findings.extend(hook.findings)
    return suppress_by_source(root, findings), stats


# ---------------------------------------------------------------------------
# stale pragmas
# ---------------------------------------------------------------------------

def count_pragmas(srcs: Dict[str, str]) -> int:
    return sum(len(parse_pragmas(src, path)[0])
               for path, src in srcs.items())


def check_stale_pragmas(raw_findings: Sequence[Finding],
                        rules_checked: set,
                        srcs: Dict[str, str]) -> List[Finding]:
    """A pragma whose rule no longer fires at its site (its line or the
    line below), judged against the pre-suppression findings of the
    planes that ran (``rules_checked``)."""
    fired: Dict[Tuple[str, str], set] = {}
    for f in raw_findings:
        fired.setdefault((f.path, f.rule), set()).add(f.line)
    findings: List[Finding] = []
    for path, src in sorted(srcs.items()):
        pragmas, _bad = parse_pragmas(src, path)
        for ln, rules in sorted(pragmas.items()):
            for rule in sorted(rules):
                if rule not in rules_checked:
                    continue
                lines = fired.get((path, rule), ())
                if ln not in lines and ln + 1 not in lines:
                    findings.append(Finding(
                        path, ln, 0, "stale-pragma",
                        f"pragma disables '{rule}' but the rule no "
                        f"longer fires at this site — remove the "
                        f"dead suppression (it documents a hazard "
                        f"that is gone)"))
    return findings


def run_stale_pragmas(root: str, raw_findings: Sequence[Finding],
                      planes_ran: set,
                      srcs: Optional[Dict[str, str]] = None
                      ) -> Tuple[List[Finding], int]:
    srcs = srcs if srcs is not None else _read_tree(root)
    rules_checked: set = set()
    for plane in planes_ran & set(PLANE_RULES):
        rules_checked |= set(PLANE_RULES[plane])
    fs = check_stale_pragmas(raw_findings, rules_checked, srcs)
    return fs, count_pragmas(srcs)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _print(findings: Sequence[Finding], plane: str,
           note: str = "") -> None:
    for f in findings:
        print(f.render())
    n = len(findings)
    state = "clean" if not n else f"{n} finding(s)"
    print(f"graftlint[{plane}]: {state}" + (f" — {note}" if note else ""))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftlint",
        description="invariant checks of the PyTorch port (see the module "
                    "docstring for the rule catalogue)")
    ap.add_argument("--plane", choices=("ast", "lock", "lower", "ranges",
                                        "budget", "strict", "all"),
                    default="all",
                    help="ast: pure-AST lint, no torch import; lock: "
                         "package-wide lock discipline (pure AST); lower: "
                         "the canonical workload's in-place / f64 / "
                         "readback checks on every entry point; ranges: "
                         "the aten interval prover (on the CPU); budget: "
                         "kernel builds and graph captures; strict: JAX's "
                         "strict workloads (the card: the sync contract; "
                         "the CPU: rank promotion and NaN); all: "
                         "everything + the stale-pragma check")
    ap.add_argument("--device", default="cuda",
                    help="device of the planes that run code (default: "
                         "cuda; the interval prover always runs on the "
                         "CPU)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect from this "
                         "file's location)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule:22s} {desc}")
        return 0
    root = args.root or default_root()
    counts: Dict[str, int] = {}
    raw: List[Finding] = []
    ran: set = set()
    budget_table: dict = {}
    pragma_count = None
    t0 = time.perf_counter()
    try:
        tree_srcs = _read_tree(root)
        if args.plane in ("ast", "all"):
            fs = run_plane_ast(root, raw_sink=raw, srcs=tree_srcs)
            _print(fs, "ast")
            counts["ast"] = len(fs)
            ran.add("ast")
        if args.plane in ("lock", "all"):
            fs, inv = run_plane_lock(root, raw_sink=raw, srcs=tree_srcs)
            _print(fs, "lock",
                   f"{inv['classes']} lock-owning classes, "
                   f"{inv['locks']} locks, {inv['guarded_attrs']} "
                   f"guarded attrs")
            counts["lock"] = len(fs)
            ran.add("lock")
        cpu = str(args.device).startswith("cpu")
        if args.plane in ("lower", "all"):
            fs = run_plane_lower(root, args.device,
                                 ranges=cpu and args.plane == "all")
            run = recorded_run(root, args.device,
                               ranges=cpu and args.plane == "all")
            _print(fs, "lower",
                   f"{sum(1 for v in run.lint.calls.values() if v)} "
                   f"entries called on {run.device} in "
                   f"{run.seconds:.1f} s")
            counts["lower"] = len(fs)
        if args.plane in ("ranges", "all"):
            from .graftlint_ranges import run_plane_ranges
            fs, st = run_plane_ranges(root, raw_sink=raw)
            _print(fs, "ranges",
                   f"{st['entries']} entries interval-checked, "
                   f"{st['casts_proven']} narrowing casts + "
                   f"{st['accums_proven']} narrow accumulates in range")
            counts["ranges"] = len(fs)
            ran.add("ranges")
        if args.plane in ("budget", "all"):
            from .graftlint_ranges import run_plane_budget
            fs, budget_table = run_plane_budget(root, args.device)
            _print(fs, "budget",
                   " ".join(f"{k}={v['measured']}/{v['budget']}"
                            for k, v in budget_table.items()))
            counts["budget"] = len(fs)
        if args.plane in ("strict", "all"):
            fs, st = run_plane_strict(root, args.device,
                                      srcs={p: s for p, s in
                                            tree_srcs.items()
                                            if p.startswith(PKG + "/")})
            note = (f"{st.get('syncs')} syncs, "
                    f"{st.get('one_off_syncs')} outside loops"
                    if "syncs" in st else "rank promotion + NaN")
            _print(fs, "strict", note)
            counts["strict"] = len(fs)
        if ran:
            fs, pragma_count = run_stale_pragmas(root, raw, ran,
                                                 srcs=tree_srcs)
            _print(fs, "pragmas", f"{pragma_count} pragma(s) in tree, "
                                  f"{len(fs)} stale")
            counts["pragmas"] = len(fs)
        parts = " ".join(f"{k}={v}" for k, v in counts.items())
        extras = []
        if pragma_count is not None:
            extras.append(f"pragmas={pragma_count}")
        if budget_table:
            extras.append("budgets[" + " ".join(
                f"{k}={v['measured']}/{v['budget']}"
                for k, v in budget_table.items()) + "]")
        extras.append(f"{time.perf_counter() - t0:.1f}s")
        print(f"graftlint summary: {parts}"
              + ((" | " + " | ".join(extras)) if extras else ""))
    except Exception as e:
        import traceback
        traceback.print_exc()
        print(f"graftlint: internal error: {type(e).__name__}: {e}")
        return 2
    return 1 if sum(counts.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
