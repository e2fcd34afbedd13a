"""The device mesh of the sharded engines, over ``torch.distributed``.

Counterpart of ``opendht_tpu/parallel/mesh.py``.  The JAX package runs
one program over a ``jax.sharding.Mesh`` with one 1-D axis
(:data:`AXIS`); the port runs one process per rank (SPMD), each running
the body that ``shard_map`` runs per device there.  A :class:`Mesh`
names that process's rank in its group, the group's size, the device it
computes on and the backend its collectives ride:

* JAX's ``all_to_all(split_axis=0, concat_axis=0, tiled=True)`` on a
  ``[D, cap, W]`` buffer is :meth:`Mesh.all_to_all`
  (``all_to_all_single`` on the contiguous buffer);
* ``psum`` / ``pmax`` are :meth:`Mesh.all_reduce` with ``"sum"`` /
  ``"max"``; ``all_gather`` is :meth:`Mesh.all_gather`.

Every exchange ships the raw bytes of its tensor (a ``uint8`` view, viewed
back on arrival), so ``uint16`` table windows and ``bool`` masks cross
either backend exactly, with no dtype conversion.

Placement follows JAX's partition specs: ``P()`` — every rank holds the
whole tensor (ids, alive, byzantine, strikes, the serve cache) — and
``P(AXIS, None)`` — rank ``r`` holds rows ``[r·n/D, (r+1)·n/D)`` (the
tables, the targets, the lookup state): :func:`shard_rows` and
:func:`gather_rows`.

Backends are explicit, never switched behind the caller's back: NCCL
needs a card per rank and refuses more ranks than cards; gloo runs ranks
on the CPU, or ranks that share one card (NCCL refuses two ranks on one
GPU).  gloo takes every collective used here on CUDA tensors (torch
2.11: it moves their bytes through host memory itself); the computation
stays on the card, and :attr:`Mesh.transport` names the path.

:func:`spawn` launches a group of ranks (the tests and ``chip_smoke.py``
share it): a file-store rendezvous, a collective timeout of tens of
seconds so a mismatched collective fails instead of hanging, any rank's
exception failing the run, and every rank joined within a limit and
killed past it.
"""

from __future__ import annotations

import datetime
import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from collections import Counter

import torch
import torch.distributed as dist

from ..models.swarm import resolve_device

AXIS = "swarm"
BACKENDS = ("gloo", "nccl")

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """One rank's view of a 1-D mesh: ``rank`` of ``size`` over
    ``backend``, computing on ``device``.  ``shape[AXIS]`` is the size,
    as on a JAX mesh.  ``group`` is a ``torch.distributed`` group (the
    default group if ``None``).  Counters: :attr:`calls` (collectives by
    name) and :attr:`bytes_sent` (bytes this rank handed each).  A
    collective recorded into a CUDA graph under capture runs nothing
    then and counts into :attr:`captured` / :attr:`captured_bytes`
    instead; whoever replays the graph adds the capture's counts
    (:meth:`count_replay`), as the kernel wrappers' counts do."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, group=None):
        self.rank, self.size = rank, size
        self.device, self.backend, self.group = device, backend, group
        self.calls: Counter = Counter()
        self.bytes_sent: Counter = Counter()
        self.captured: Counter = Counter()
        self.captured_bytes: Counter = Counter()

    @property
    def shape(self) -> dict:
        return {AXIS: self.size}

    @property
    def transport(self) -> str:
        """The backend and the device: ``"gloo on cuda"`` is ranks sharing
        a card, their bytes crossing through host memory inside gloo."""
        return f"{self.backend} on {self.device.type}"

    def reset_counters(self) -> None:
        self.calls.clear()
        self.bytes_sent.clear()

    def _run(self, name: str, fn, out: torch.Tensor, inp: torch.Tensor):
        """Run collective ``fn(out, inp)`` and count it (into the capture
        counters while a CUDA graph is being captured)."""
        capturing = (inp.device.type == "cuda"
                     and torch.cuda.is_current_stream_capturing())
        calls, sent = ((self.captured, self.captured_bytes) if capturing
                       else (self.calls, self.bytes_sent))
        calls[name] += 1
        sent[name] += inp.numel() * inp.element_size()
        fn(out, inp)
        return out

    def count_replay(self, calls: dict, nbytes: dict) -> None:
        """A replay of a captured graph ran ``calls[name]`` collectives
        moving ``nbytes[name]`` bytes (the capture counters' difference
        across its capture)."""
        self.calls.update(calls)
        self.bytes_sent.update(nbytes)

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        """``[D, ...]`` → ``[D, ...]``: block ``j`` goes to rank ``j``,
        and block ``i`` of the result came from rank ``i`` (JAX's tiled
        ``all_to_all`` on axis 0).  The bytes cross unchanged."""
        if buf.shape[0] != self.size:
            raise ValueError(f"all_to_all needs a leading axis of "
                             f"{self.size}, got {tuple(buf.shape)}")
        raw = buf.contiguous().reshape(self.size, -1).view(torch.uint8)
        out = torch.empty_like(raw)
        self._run("all_to_all", lambda o, i: dist.all_to_all_single(
            o, i, group=self.group), out, raw)
        return out.view(buf.dtype).reshape(buf.shape)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A reduced copy of ``x`` (``op`` ``"sum"`` or ``"max"``), the
        same on every rank."""
        out = x.clone()
        return self._run(f"all_reduce_{op}", lambda o, i: dist.all_reduce(
            o, op=_OPS[op], group=self.group), out, out)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[D, *x.shape]``: every rank's ``x``, in rank order."""
        x = x.contiguous()
        raw = x.reshape(-1).view(torch.uint8)
        out = torch.empty((self.size, raw.numel()), dtype=raw.dtype,
                          device=x.device)

        # The collective fills the row views of ``out`` in place.
        self._run("all_gather", lambda o, i: dist.all_gather(
            list(o.unbind(0)), i, group=self.group), out, raw)
        return out.view(x.dtype).reshape(self.size, *x.shape)

    def host_ints(self, values, op: str = "sum") -> list[int]:
        """Reduce a few host integers over the group → the same list on
        every rank (one collective, one readback): how every rank takes
        the same host decision."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        return [int(v) for v in self.all_reduce(t, op).tolist()]

    def barrier(self) -> None:
        self.host_ints([0])

    def host_max(self, value: float) -> float:
        """The largest of the ranks' host ``value`` s, the same on every
        rank (one ``all_reduce``): the serve engines' clock.  gloo
        reduces it on the CPU, so the device stream is never waited on;
        NCCL, which takes device tensors only, on the card; one rank
        reduces nothing."""
        if self.size == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64,
                         device=self.device if self.backend == "nccl"
                         else "cpu")
        return float(self.all_reduce(t, "max")[0])

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(size: int, rank: int, *, backend: str, device,
              init_method: str, timeout: float = 60.0) -> Mesh:
    """Join rank ``rank`` of a ``size``-rank group (the process group of
    this process) and return its :class:`Mesh`.  ``backend`` is
    ``"gloo"`` or ``"nccl"``, explicitly; NCCL needs a card per rank and
    raises for more ranks than cards.  ``timeout`` (seconds) bounds every
    collective, so a rank waiting on a collective its peers never join
    fails instead of hanging."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices only")
        if size > torch.cuda.device_count():
            raise ValueError(
                f"nccl refuses {size} ranks on {torch.cuda.device_count()} "
                f"card(s): NCCL needs a card per rank; ranks that share a "
                f"card use backend='gloo'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass "
                               "device='cpu' to run the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return Mesh(rank, size, dev, backend)


def shard_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``x`` under ``P(AXIS)``: ``[r·n/D,
    (r+1)·n/D)`` (``n`` must divide the mesh)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide the {mesh.size}-rank "
                         f"mesh")
    m = n // mesh.size
    return x[mesh.rank * m:(mesh.rank + 1) * m]


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of a ``P(AXIS)`` tensor, in rank order (the
    whole tensor, on every rank)."""
    g = mesh.all_gather(x)
    return g.reshape(-1, *x.shape[1:])


def gather_many(mesh: Mesh, xs) -> list:
    """Every rank's rows of each of the ``P(AXIS)`` tensors ``xs`` (rows
    of equal count), whole on every rank, in one ``all_gather``: they
    cross packed side by side as int64 columns (every dtype here widens
    exactly) and come back in their own dtypes and shapes."""
    flat = gather_rows(mesh, torch.cat(
        [x.reshape(x.shape[0], -1).to(torch.int64) for x in xs], dim=1))
    out, c = [], 0
    for x in xs:
        w = math.prod(x.shape[1:])
        # graftlint: disable=narrow-cast-unproven (each column returns to its own dtype: it was widened exactly from that dtype when packed above, but the packed matrix's interval joins every column)
        out.append(flat[:, c:c + w].reshape(-1, *x.shape[1:]).to(x.dtype))
        c += w
    return out


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, size, backend, device, init_method, timeout,
               threads, args, out_q):
    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = make_mesh(size, rank, backend=backend, device=device,
                         init_method=init_method, timeout=timeout)
        try:
            result = fn(mesh, *args)
        finally:
            mesh.close()
        out_q.put((rank, True, result))
    except BaseException:                         # reported to the parent
        out_q.put((rank, False, traceback.format_exc()))


def spawn(fn, size: int, *, backend: str, device=None, args=(),
          timeout: float = 60.0, limit: float = 600.0,
          threads: int | None = None) -> list:
    """Run ``fn(mesh, *args)`` in ``size`` fresh processes, one per rank,
    and return their results in rank order (picklable values: numpy
    arrays, dicts, numbers).

    ``fn`` must be importable by name (a module-level function of a
    module that the children can import).  The ranks meet through a file
    store in a fresh temporary directory.  ``timeout`` (seconds) bounds
    each collective; ``limit`` the whole run: past it every rank is
    killed and ``TimeoutError`` raised.  A rank that raises (or dies)
    fails the run at once: the others are killed and ``RuntimeError``
    carries its traceback.  ``threads`` sets each rank's torch thread
    count.  ``device`` is the card unless the caller asks for the CPU
    (:func:`~opendht_tpu_torch.models.swarm.resolve_device`)."""
    import torch.multiprocessing as mp
    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mesh-")
    init = "file://" + os.path.join(tmp, "store")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, size, backend, str(device), init,
                               timeout, threads, args, out_q), daemon=True)
             for r in range(size)]
    try:
        for p in procs:
            p.start()
        results: dict = {}
        deadline = time.monotonic() + limit
        while len(results) < size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(size)) - set(results))} did "
                    f"not finish within {limit:.0f} s")
            try:
                rank, ok, payload = out_q.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    # A rank's report may still be in flight: one more look.
                    try:
                        rank, ok, payload = out_q.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} died (exit code "
                            f"{procs[dead[0]].exitcode}) without a result")
                else:
                    continue
            if not ok:
                # Peers of a failed rank fail in turn: gather their
                # reports briefly, and name every failed rank.
                errors = {rank: payload}
                t_end = time.monotonic() + 2.0
                while time.monotonic() < t_end:
                    try:
                        r2, ok2, p2 = out_q.get(timeout=0.2)
                    except queue_mod.Empty:
                        continue
                    if not ok2:
                        errors[r2] = p2
                raise RuntimeError("\n".join(
                    f"rank {r} failed:\n{errors[r]}" for r in sorted(errors)))
            results[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [results[r] for r in range(size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        out_q.close()
        shutil.rmtree(tmp, ignore_errors=True)
