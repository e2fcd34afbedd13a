"""K2 (the fused round) and the fused-round engine against the JAX
package, bit for bit: ``fused_round_plain`` against ``fused_round_pallas``
(interpret mode) on named cases, the port's ``merge_impl="fused-round"``
step against JAX's ``"pallas-round"`` step, its whole lookups against
JAX's lookups, and K3′ ``nearest_ids`` against JAX's.

The kernel cases and the step share one shape (L = 128 rows, the
default ``tile_l = 128``, a 512-node table) and one call signature, so
the interpreter (``interpret=None`` resolves to it off a TPU) compiles
once per ``keep``.  Every comparison is exact (integers only, tolerance
0).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import swarm as jsw
from opendht_tpu.ops.pallas_kernels import fused_round_pallas
from opendht_tpu.ops.pallas_kernels import nearest_ids as jax_nearest_ids
from opendht_tpu_torch.convert import swarm_from_numpy, u32_tensor
from opendht_tpu_torch.models import swarm as tsw
from opendht_tpu_torch.ops import kernels

from torch_port_cases import (FK, FL, FUSED_CASES, assert_same, fused_case,
                              to_torch)

QUORUM = 8
N, NL = 2048, 256
CFG_J = jsw.SwarmConfig.for_nodes(N)
CFG_T = tsw.SwarmConfig.for_nodes(N, device="cpu",
                                  merge_impl="fused-round")
KEY = jax.random.PRNGKey(7)


def to_port(sw):
    return swarm_from_numpy(np.asarray(sw.ids), np.asarray(sw.tables),
                            np.asarray(sw.alive), device="cpu")


@pytest.mark.parametrize("name,seed,keep", FUSED_CASES)
def test_fused_round_plain_matches_pallas(name, seed, keep):
    case = fused_case(name, seed)
    want = fused_round_pallas(*(jnp.asarray(x) for x in case), bucket_k=FK,
                              quorum=QUORUM, keep=keep)
    got = kernels.fused_round(*(to_torch(x) for x in case), bucket_k=FK,
                              quorum=QUORUM, keep=keep)
    assert_same(want, got, f"fused_round {name} seed={seed} keep={keep}")


def test_fused_round_config():
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert tsw.resolve_merge_impl(CFG_T, card) == "fused-round"
    assert tsw.resolve_merge_impl(CFG_T, cpu) == "fused-round"
    auto = CFG_T._replace(merge_impl="auto")
    assert tsw.resolve_merge_impl(auto, card) == "kernel"


def _numpy_swarm(cfg_t, seed, kill_frac):
    """A churned swarm from numpy draws (sorted ids, per-bucket uniforms,
    alive mask), built by the port (``test_torch_swarm.py`` holds its
    tables byte-equal to JAX's from the same draws): ``(port swarm, JAX
    swarm)``."""
    r = np.random.default_rng(seed)
    n, k = cfg_t.n_nodes, cfg_t.bucket_k
    ids = r.integers(0, 2**32, (n, 5), dtype=np.uint32)
    ids = ids[np.lexsort(ids.T[::-1])]
    draws = [r.random((n, k), dtype=np.float32)
             for _ in range(cfg_t.n_buckets)]
    tables = tsw.build_tables(u32_tensor(ids[:, 0], "cpu"), cfg_t,
                              lambda b: torch.from_numpy(draws[b]))
    alive = r.random(n) >= kill_frac
    sw_t = swarm_from_numpy(ids, tables.numpy(), alive, device="cpu")
    return sw_t, jsw.Swarm(ids=jnp.asarray(ids),
                           tables=jnp.asarray(tables.numpy()),
                           alive=jnp.asarray(alive))


def test_fused_round_step_bit_equal():
    """Three rounds of the port's fused step against JAX's
    ``"pallas-round"`` step (``_fused_round_step``, the body its
    ``lookup_step`` jits; interpret mode) on a churned 512-node swarm:
    dead-node evictions and idle solicitations included."""
    cfg_j = jsw.SwarmConfig.for_nodes(512, merge_impl="pallas-round")
    cfg_t = tsw.SwarmConfig.for_nodes(512, device="cpu",
                                      merge_impl="fused-round")
    sw_t, sw_j = _numpy_swarm(cfg_t, 9, 0.2)
    assert tuple(sw_t.tables.shape) == fused_case("round", 0)[0].shape
    r = np.random.default_rng(1)
    tg = r.integers(0, 2**32, (FL, 5), dtype=np.uint32)
    origins = r.choice(np.flatnonzero(sw_t.alive.numpy()), FL)
    st_t = tsw.lookup_init(sw_t, cfg_t, u32_tensor(tg, "cpu"),
                           torch.from_numpy(origins.astype(np.int32)))
    st_j = jsw.LookupState(
        targets=jnp.asarray(tg), idx=jnp.asarray(st_t.idx.numpy()),
        dist=jnp.asarray(st_t.dist.numpy().astype(np.uint32)),
        queried=jnp.asarray(st_t.queried.numpy()),
        done=jnp.asarray(st_t.done.numpy()),
        hops=jnp.asarray(st_t.hops.numpy()))
    for rnd in range(3):
        st_j = jsw._fused_round_step(sw_j, cfg_j, st_j)
        st_t = tsw.lookup_step(sw_t, cfg_t, st_t)
        assert_same(st_j[:6], st_t, f"fused step, round {rnd}")
    assert int(np.asarray(st_j.hops).sum()) > 0


@pytest.fixture(scope="module")
def healthy():
    return jsw.build_swarm(KEY, CFG_J)


@pytest.fixture(scope="module")
def churned(healthy):
    return jsw.churn(healthy, jax.random.PRNGKey(9), 0.25, CFG_J)


@pytest.fixture(scope="module")
def targets():
    return jax.random.bits(jax.random.PRNGKey(1), (NL, 5), jnp.uint32)


@pytest.mark.parametrize("which", ["healthy", "churned"])
@pytest.mark.parametrize("compact", [True, False])
def test_fused_lookup_bit_equal(which, compact, request, targets):
    """The fused-round engine, compacted or not, against JAX's
    uncompacted lookup (JAX's own tests hold its ``"pallas-round"``
    engine bit-equal to this one, and its compacted loop to the
    uncompacted one; one JAX program serves every case)."""
    sw = request.getfixturevalue(which)
    key = jax.random.PRNGKey(2)
    want = jsw.lookup(sw, CFG_J, targets, key, compact=False)
    origins = torch.from_numpy(np.array(
        jsw._sample_origins(key, sw.alive, NL)))
    got = tsw.lookup(to_port(sw), CFG_T, u32_tensor(np.asarray(targets),
                                                    "cpu"),
                     origins=origins, compact=compact, device="cpu")
    assert_same(want, got, f"fused lookup {which} compact={compact}")
    assert bool(got.done.all())


def test_fused_round_requires_aug_tables(targets):
    cfg = CFG_T._replace(aug_tables=False)
    sw = tsw.build_swarm(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tg = u32_tensor(np.asarray(targets[:8]), "cpu")
    with pytest.raises(ValueError, match="augmented tables"):
        tsw.lookup(sw, cfg, tg, device="cpu")


def test_nearest_ids_plain_matches_pallas():
    r = np.random.default_rng(5)
    ids = r.integers(0, 2**32, (700, 5), dtype=np.uint32)
    tg = np.concatenate([ids[[0, 3, 699]],
                         r.integers(0, 2**32, (6, 5), dtype=np.uint32)])
    tg[5, 0] |= np.uint32(0xFFF00000)
    want = jax_nearest_ids(jnp.asarray(ids), jnp.asarray(tg), tile_l=8,
                           tile_n=256, interpret=True)
    got = kernels.nearest_ids(to_torch(ids), to_torch(tg))
    assert_same([want], [got], "nearest_ids")
    assert got[:3].tolist() == [0, 3, 699]
    col0 = kernels.nearest_k_ids(to_torch(ids), to_torch(tg), 8)[:, 0]
    assert torch.equal(got, col0)
