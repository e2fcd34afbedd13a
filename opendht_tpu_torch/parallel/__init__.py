"""Mesh sharding over ``torch.distributed``: data-parallel and
table-sharded lookups, the node-sharded store and the sharded PHT index
(one process per rank)."""

from .mesh import AXIS, Mesh, gather_rows, make_mesh, shard_rows, spawn  # noqa: F401
from .sharded import (  # noqa: F401
    chaos_sharded_lookup,
    contended_lookup,
    data_parallel_lookup,
    sharded_lookup,
    traced_sharded_lookup,
)
