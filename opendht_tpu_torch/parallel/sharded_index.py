"""Mesh-sharded twin of the device PHT index.

Counterpart of ``opendht_tpu/parallel/sharded_index.py``.
:class:`~opendht_tpu_torch.models.index.DeviceIndex` drives the trie
through two engine ops, a batched get and a batched put; the sharded
twin rebinds them onto the routed mesh ops
(:func:`~opendht_tpu_torch.parallel.sharded_storage.sharded_get` /
:func:`~opendht_tpu_torch.parallel.sharded_storage.sharded_announce`),
so the trie encoding, the leaf walk, splits and range scans are the
same code on one device and on a mesh.

The host logic runs on every rank alike: each op's batch is whole on
every rank (padded to a power of two of at least 16 rows, so it divides
a mesh of up to 16 ranks); each rank routes its rows of it, and a get's
answers are gathered back whole (one ``all_gather``).  The origins of op
``i`` are ``draws(i, rows)`` — the whole batch's, the same on every
rank — or a draw from a generator seeded ``seed`` on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.index import DeviceIndex, IndexSpec
from ..models.storage import StoreConfig, SwarmStore
from ..models.swarm import Swarm, SwarmConfig
from .mesh import Mesh, gather_rows, shard_rows
from .sharded_storage import sharded_announce, sharded_get


class ShardedDeviceIndex(DeviceIndex):
    """The device PHT engine with its get and put routed over ``mesh``:
    ``swarm`` is this rank's shard (tables rows), ``store`` its store
    shard (:func:`~opendht_tpu_torch.parallel.sharded_storage.shard_store`).
    Gets and puts use ``capacity_factor`` (default 4.0, as JAX's)."""

    def __init__(self, swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                 scfg: StoreConfig, spec: IndexSpec, mesh: Mesh,
                 capacity_factor: float = 4.0, seed: int = 0, *,
                 draws: Callable[[int, int], torch.Tensor] | None = None):
        super().__init__(swarm, cfg, store, scfg, spec, seed=seed,
                         draws=draws, device=mesh.device)
        self.mesh = mesh
        self.capacity_factor = capacity_factor

    def _get_raw(self, keys: torch.Tensor):
        m = self.mesh
        res = sharded_get(
            self.swarm, self.cfg, self.store, self.scfg, shard_rows(m, keys),
            m, capacity_factor=self.capacity_factor,
            origins=shard_rows(m, self._next_origins(keys.shape[0])))
        rows = gather_rows(m, torch.cat(
            [res.hit.to(torch.int64)[:, None], res.val[:, None], res.payload],
            dim=1))
        return rows[:, 0] != 0, rows[:, 1], rows[:, 2:]

    def _put_raw(self, keys, vals, seqs, payloads) -> None:
        m = self.mesh
        self.store, _rep = sharded_announce(
            self.swarm, self.cfg, self.store, self.scfg, shard_rows(m, keys),
            shard_rows(m, vals), shard_rows(m, seqs), 0, m,
            capacity_factor=self.capacity_factor,
            payloads=shard_rows(m, payloads),
            origins=shard_rows(m, self._next_origins(keys.shape[0])))
