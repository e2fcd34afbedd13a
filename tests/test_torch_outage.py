"""Keys inside a contiguous outage: the port's lookups against the JAX
package's.  Kill a contiguous 2 % range of the sorted ids with
``kill_node_range`` (no heal), look up keys that fall inside that range
from the same origins in both packages, and hold the found sets equal —
including which answers end empty (``found[:, 0] == -1``).  This is how
ROADMAP's soak observation (empty answers for keys inside the soak's
outage) is classified: an engine behaviour the two packages share, not a
fault of the port.  Every comparison is exact."""

import numpy as np
import pytest

import jax
import torch

from opendht_tpu.models import monitor as jm
from opendht_tpu.models import swarm as jsw
from opendht_tpu_torch.models import monitor as tm
from opendht_tpu_torch.models import swarm as tsw

from torch_port_cases import assert_same, port_cfg, port_swarm, to_torch

N, L = 16_384, 512


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_keys_inside_a_contiguous_outage_equal():
    cfg = jsw.SwarmConfig.for_nodes(N)
    sw = jsw.build_swarm(jax.random.PRNGKey(0), cfg)
    lo = N // 3
    hi = lo + N // 50                                    # 2 % of the ids
    dead_j = jm.kill_node_range(sw, jax.numpy.int32(lo),
                                jax.numpy.int32(hi), cfg)
    dead_t = tm.kill_node_range(port_swarm(sw), lo, hi, port_cfg(cfg))
    assert_same([dead_j.alive], [dead_t.alive], "outage mask")
    # Keys inside the dead range: a dead node's first limb, the rest
    # random — each key's nearest ids are dead.
    r = np.random.default_rng(4)
    ids = np.asarray(sw.ids)
    tg = ids[r.integers(lo, hi, L)].copy()
    tg[:, 1:] = r.integers(0, 2**32, (L, 4), dtype=np.uint32)
    key = jax.random.PRNGKey(5)
    og = torch.from_numpy(np.array(jsw._sample_origins(key, dead_j.alive, L)))
    res_j = jsw.lookup(dead_j, cfg, jax.numpy.asarray(tg), key)
    res_t = tsw.lookup(dead_t, port_cfg(cfg), to_torch(tg), origins=og,
                       device="cpu")
    assert_same(res_j, res_t, "lookups inside the outage")
    empty_j = np.asarray(res_j.found)[:, 0] < 0
    assert np.array_equal(empty_j, res_t.found[:, 0].numpy() < 0)
    assert bool(res_t.done.all())
    # Most of these answers end empty, in both packages alike (the
    # exact re-sort of the head ranks an unqueried entry first).
    assert empty_j.sum() > L // 2
    # The answers name live nodes only, none of them inside the range.
    f = res_t.found.numpy()
    assert not np.any((f >= lo) & (f < hi))
