"""Carry swarm and lookup state across from the JAX package.

The JAX engine's ``Swarm``, ``LookupState`` (a serve state too),
``SwarmStore``, the serve engine's ``ResultCache`` and ``ServeRings``
and the monitor's ``FreshnessState`` are pytrees of arrays, and a
``DeviceIndex`` and a ``SoakEngine`` carry host state beside them;
passed here as numpy arrays, they become the port's tensors on the
chosen device (the card unless the caller asks for the CPU, as every
entry point resolves it), so both packages then compute on the same state — the
counterpart of carrying a model's weights across.  Unsigned 32-bit
arrays widen to int64 (:mod:`opendht_tpu_torch.ops.u32`); tables keep
their bytes.  For the sharded engines, :func:`swarm_shard_from_numpy`,
:func:`state_shard_from_numpy` and :func:`store_shard_from_numpy` give
one rank its rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.index import DeviceIndex
from .models.monitor import FreshnessState
from .models.serve import ResultCache, ServeRings
from .models.storage import NODE_LEAVES, SwarmStore
from .models.swarm import LookupState, LookupTrace, Swarm, resolve_device


def u32_tensor(x, device) -> torch.Tensor:
    """A uint32 array as an int64 tensor in ``0 .. 2**32 - 1``."""
    return torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(np.int64)
                            ).to(device)


def swarm_from_numpy(ids, tables, alive, byzantine=None,
                     device=None) -> Swarm:
    """``ids [N,5] uint32``, ``tables`` (``uint16`` augmented or
    ``int32`` plain rows, byte-for-byte), ``alive [N] bool`` and,
    optionally, ``byzantine [N] bool``."""
    device = resolve_device(device)
    tables = np.array(tables)                 # a writable copy
    if tables.dtype not in (np.uint16, np.int32):
        raise TypeError(f"tables must be uint16 or int32, got {tables.dtype}")
    return Swarm(ids=u32_tensor(ids, device),
                 tables=torch.from_numpy(tables).to(device),
                 alive=_tensor(alive, bool, device),
                 byzantine=(None if byzantine is None
                            else _tensor(byzantine, bool, device)))


def _rank_rows(x, rank: int, size: int):
    """Rows ``[rank·n/size, (rank+1)·n/size)`` of a host array."""
    x = np.asarray(x)
    n = x.shape[0]
    if n % size:
        raise ValueError(f"{n} rows do not divide the {size}-rank mesh")
    m = n // size
    return x[rank * m:(rank + 1) * m]


def swarm_shard_from_numpy(ids, tables, alive, byzantine=None, *,
                           rank: int, size: int, device=None) -> Swarm:
    """One rank's shard of a JAX swarm for the sharded engines: its rows
    of the tables (``P(AXIS)``), and the ids, alive and byzantine masks
    whole (``P()``)."""
    return swarm_from_numpy(ids, _rank_rows(tables, rank, size), alive,
                            byzantine, device=device)


def state_shard_from_numpy(targets, idx, dist, queried, done, hops,
                           admitted_round=None, completed_round=None, *,
                           rank: int, size: int, device=None) -> LookupState:
    """One rank's rows of a JAX sharded ``LookupState`` (a sharded serve
    engine's state too): the rows ``[r·C/D, (r+1)·C/D)`` of every
    field."""
    fields = [None if x is None else _rank_rows(x, rank, size)
              for x in (targets, idx, dist, queried, done, hops,
                        admitted_round, completed_round)]
    return state_from_numpy(*fields, device=device)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def _field(x: np.ndarray, device) -> torch.Tensor:
    """A field of its own dtype; uint32 widens to int64."""
    return (u32_tensor(x, device) if x.dtype == np.uint32
            else _tensor(x, x.dtype, device))


def state_from_numpy(targets, idx, dist, queried, done, hops,
                     admitted_round=None, completed_round=None,
                     device=None) -> LookupState:
    """A JAX ``LookupState`` as numpy arrays → the port's state; the
    lifecycle fields stay ``None`` where not given."""
    device = resolve_device(device)

    def t(x, dtype):
        return None if x is None else _tensor(x, dtype, device)

    return LookupState(targets=u32_tensor(targets, device),
                       idx=t(idx, np.int32), dist=u32_tensor(dist, device),
                       queried=t(queried, bool), done=t(done, bool),
                       hops=t(hops, np.int32),
                       admitted_round=t(admitted_round, np.int32),
                       completed_round=t(completed_round, np.int32))


def trace_from_numpy(*fields, device=None) -> LookupTrace:
    """A JAX ``LookupTrace`` as numpy arrays, in field order (nine
    ``[max_steps]`` counter rows, then ``rounds``) → the port's trace."""
    device = resolve_device(device)
    if len(fields) != len(LookupTrace._fields):
        raise ValueError(f"a LookupTrace has {len(LookupTrace._fields)} "
                         f"fields, got {len(fields)}")
    return LookupTrace(*[_tensor(x, np.int32, device) for x in fields])


def store_from_numpy(*fields, device=None) -> SwarmStore:
    """A JAX ``SwarmStore`` as numpy arrays, in field order → the port's
    store.  The JAX store's flat key, payload and listener arrays become
    the shaped ``[N,S,5]``, ``[N,S,W]``, ``[N,LS,5]`` and ``[N,LS]``
    planes (the same elements in the same order); uint32 fields widen to
    int64."""
    device = resolve_device(device)
    if len(fields) != len(SwarmStore._fields):
        raise ValueError(f"a SwarmStore has {len(SwarmStore._fields)} "
                         f"fields, got {len(fields)}")
    f = dict(zip(SwarmStore._fields, map(np.asarray, fields)))
    n, s = f["vals"].shape
    ls = f["lids"].size // max(n, 1)
    w = f["npayload"].shape[1]
    shapes = {"keys": (n, s, 5), "lkeys": (n, ls, 5), "lids": (n, ls),
              "lexps": (n, ls), "payload": (n, s, w)}
    out = {}
    for name, x in f.items():
        out[name] = _field(x.reshape(shapes.get(name, x.shape)), device)
    return SwarmStore(**out)


def store_shard_from_numpy(*fields, rank: int, size: int,
                           device=None) -> SwarmStore:
    """One rank's shard of a whole JAX ``SwarmStore`` (numpy arrays, in
    field order) for the sharded storage engines: its node rows
    ``[r·N/D, (r+1)·N/D)`` of every node leaf (the flat key, payload and
    listener arrays by their node rows too), and the listener delivery
    tables (``notified``, ``nseqs``, ``nvals``, ``npayload``, ``nsizes``)
    whole, as every rank holds them."""
    if len(fields) != len(SwarmStore._fields):
        raise ValueError(f"a SwarmStore has {len(SwarmStore._fields)} "
                         f"fields, got {len(fields)}")
    f = dict(zip(SwarmStore._fields, map(np.asarray, fields)))
    n = f["vals"].shape[0]
    out = []
    for name, x in f.items():
        if name not in NODE_LEAVES:
            out.append(x)
        elif x.shape[0] == n:
            out.append(_rank_rows(x, rank, size))
        else:           # a flat key, payload or listener array: node rows
            out.append(_rank_rows(x.reshape(n, -1), rank, size).reshape(-1))
    return store_from_numpy(*out, device=device)


def cache_from_numpy(*fields, device=None) -> ResultCache:
    """A JAX serve ``ResultCache`` as numpy arrays, in field order
    (``keys``, ``found``, ``hops``, ``fill_round``, ``fill_epoch``,
    ``epoch``) → the port's cache; uint32 fields widen to int64."""
    device = resolve_device(device)
    if len(fields) != len(ResultCache._fields):
        raise ValueError(f"a ResultCache has {len(ResultCache._fields)} "
                         f"fields, got {len(fields)}")
    return ResultCache(*[_field(np.asarray(x), device) for x in fields])


def rings_from_numpy(*fields, device=None) -> ServeRings:
    """A JAX ``ServeRings`` as numpy arrays, in field order → the port's
    rings (the ring's uint32 key limbs widen to int64, the counters
    stay int32)."""
    device = resolve_device(device)
    if len(fields) != len(ServeRings._fields):
        raise ValueError(f"a ServeRings has {len(ServeRings._fields)} "
                         f"fields, got {len(fields)}")
    return ServeRings(*[_field(np.asarray(x), device) for x in fields])


def freshness_from_numpy(*fields, device=None) -> FreshnessState:
    """A JAX ``FreshnessState`` as numpy arrays, in field order → the
    port's freshness plane (``[N]`` int32 each)."""
    device = resolve_device(device)
    if len(fields) != len(FreshnessState._fields):
        raise ValueError(f"a FreshnessState has "
                         f"{len(FreshnessState._fields)} fields, got "
                         f"{len(fields)}")
    return FreshnessState(*[_tensor(x, np.int32, device) for x in fields])


def load_index_state(ix: DeviceIndex, store_fields, max_depth: int, op: int,
                     stats: dict) -> DeviceIndex:
    """Give the port's ``ix`` the state of a JAX ``DeviceIndex``: its
    store (numpy arrays in field order, as :func:`store_from_numpy`
    takes them), its deepest canary ``_max_depth``, its store-op count
    ``_op`` and its ``stats``.  Returns ``ix``."""
    ix.store = store_from_numpy(*store_fields, device=ix.device)
    ix._max_depth, ix._op = int(max_depth), int(op)
    ix.stats = {k: int(v) for k, v in stats.items()}
    return ix


def load_soak_state(soak, wc, store_now: int):
    """Give the port's ``SoakEngine`` a JAX engine's work-class plane
    (``[slots]`` int32) and store clock (a u32).  Returns ``soak``."""
    soak.wc = _tensor(wc, np.int32, soak.device)
    soak.store_now = int(store_now) & 0xFFFFFFFF
    return soak
