"""The port's XOR-metric ops against the JAX package, bit for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from opendht_tpu.ops import xor_metric as jx
from opendht_tpu_torch.ops import xor_metric as tx
from opendht_tpu_torch.ops.u32 import lexsort

from torch_port_cases import (C, MAXU, S, adversarial_responses,
                              assert_same, make_frontier, to_torch)


def _ids(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 5),
                                                dtype=np.uint32)


def test_prefix_len32_edges():
    vals = np.array([0, 1, 2, 3, 0xFFFF, 0x10000, 2**31 - 1, 2**31,
                     2**32 - 2, 2**32 - 1], np.uint32)
    vals = np.concatenate([vals, np.random.default_rng(0).integers(
        0, 2**32, 256, dtype=np.uint32)])
    want = np.asarray(jx.prefix_len32(jnp.asarray(vals)))
    got = tx.prefix_len32(to_torch(vals)).numpy()
    assert np.array_equal(want, got)
    assert got[:4].tolist() == [32, 31, 30, 30]
    assert got[7:10].tolist() == [0, 0, 0]


def test_lexsort_matches_build_ids_sort():
    raw = _ids(1, 3000)
    raw[:40, 0] = raw[40:80, 0]            # ties on the leading limb
    want = np.asarray(jnp.stack(jax.lax.sort(
        tuple(jnp.asarray(raw[:, i]) for i in range(5)), num_keys=5), -1))
    t = to_torch(raw)
    got = t[lexsort([t[:, i] for i in range(5)], dim=0)]
    assert np.array_equal(want.astype(np.int64), got.numpy())


def test_xor_less_and_lex_less():
    a, b = _ids(2, 200), _ids(3, 200)
    b[:50] = a[:50]
    b[50:100, :3] = a[50:100, :3]
    for jf, tf in ((jx.xor_less, tx.xor_less), (jx.lex_less, tx.lex_less)):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        assert np.array_equal(want, tf(to_torch(a), to_torch(b)).numpy())


def test_sort_by_distance():
    ids = _ids(4, 6 * 40).reshape(6, 40, 5)
    ids[:, 7] = ids[:, 3]                  # equal distances keep order
    tg = _ids(5, 6)
    pay = np.arange(6 * 40, dtype=np.int32).reshape(6, 40)
    want = jx.sort_by_distance(jnp.asarray(ids), jnp.asarray(tg),
                               jnp.asarray(pay))
    got = tx.sort_by_distance(to_torch(ids), to_torch(tg), to_torch(pay))
    assert_same(want, got, "sort_by_distance")


@pytest.mark.parametrize("k", [1, 8, 33])
def test_closest_nodes(k):
    ids, tg = _ids(6, 500), _ids(7, 1)[0]
    want = jx.closest_nodes(jnp.asarray(ids), jnp.asarray(tg), k)
    got = tx.closest_nodes(to_torch(ids), to_torch(tg), k)
    assert_same([want], [got], f"closest_nodes k={k}")


@pytest.mark.parametrize("seed", range(3))
def test_merge_shortlists_d0(seed):
    r = np.random.default_rng(seed)
    d0 = r.integers(0, 2**32, (32, 40), dtype=np.uint32)
    d0[:, 3] = MAXU
    idx = r.integers(-1, 30, (32, 40), dtype=np.int32)   # many dups
    q = (r.random((32, 40)) < 0.4) & (idx >= 0)
    for keep in (14, 40):
        want = jx.merge_shortlists_d0(jnp.asarray(d0), jnp.asarray(idx),
                                      jnp.asarray(q), keep)
        got = tx.merge_shortlists_d0(to_torch(d0), to_torch(idx),
                                     to_torch(q), keep)
        assert_same(want, got, f"merge_shortlists_d0 keep={keep}")


def _rank_case(seed, keep, ladder_w=None, live_w=None):
    fi, fd, fq = make_frontier(seed)
    ri, rd = adversarial_responses(1000 + seed, fi)
    if live_w is not None:
        ri[:, live_w:] = -1
        rd[:, live_w:] = MAXU
    j = [jnp.asarray(x) for x in (fi, fd, fq, ri, rd)]
    t = [to_torch(x) for x in (fi, fd, fq, ri, rd)]
    if ladder_w is False:
        return (jx.rank_merge_round_d0(*j, keep),
                tx.rank_merge_round_d0(*t, keep))
    return (jx.rank_merge_round_d0_w(*j, keep, merge_w=ladder_w),
            tx.rank_merge_round_d0_w(*t, keep, merge_w=ladder_w))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("keep", [S, 3, S + C + 5])
def test_rank_merge_round_d0(seed, keep):
    want, got = _rank_case(seed, keep, ladder_w=False)
    assert_same(want, got, f"rank merge seed={seed} keep={keep}")


@pytest.mark.parametrize("merge_w", [8, 16, 32, None])
@pytest.mark.parametrize("live_w", [12, 32])
def test_rank_merge_round_d0_w_rungs(merge_w, live_w):
    """Every rung, covering the live columns (narrow path) or not (the
    overflow guard's full-width path)."""
    want, got = _rank_case(11, S, ladder_w=merge_w, live_w=live_w)
    assert_same(want, got, f"ladder rung={merge_w} live={live_w}")


def test_rank_merge_round_d0_w_pads_wide_keep():
    want, got = _rank_case(12, S + C + 3, ladder_w=8, live_w=8)
    assert_same(want, got, "ladder keep > S + rung")


def test_ladder_widths():
    assert tx.merge_ladder_widths(64, 16) == jx.merge_ladder_widths(64, 16)
    assert tx.merge_ladder_widths(48, 16) == [16, 32, 48]
    for wneed in (0, 16, 17, 33, 64):
        assert (tx.pick_merge_width(wneed, 64, 16)
                == jx.pick_merge_width(wneed, 64, 16))


@pytest.mark.parametrize("c_wide", [241, 242])
def test_u8_u16_boundary_widths(c_wide):
    """S + C across 255 (where the JAX accumulators switch u8 → u16),
    positions driven to the top of the output."""
    r = np.random.default_rng(100 + c_wide)
    cd0 = r.integers(0, 2**32, (8, S + c_wide), dtype=np.uint32)
    ci = r.integers(-1, 10**6, (8, S + c_wide), dtype=np.int32)
    cq = (r.random((8, S + c_wide)) < 0.5) & (ci >= 0)
    fi, fd, fq = (np.asarray(x) for x in jx.merge_shortlists_d0(
        jnp.asarray(cd0), jnp.asarray(ci), jnp.asarray(cq), keep=S))
    ri = r.integers(-1, 10**6, (8, c_wide), dtype=np.int32)
    rd = r.integers(0, 2**32, (8, c_wide), dtype=np.uint32)
    rd[ri < 0] = MAXU
    ri[:, 0] = fi[:, 0]
    ri[:, 1] = ri[:, 2]
    rd[:, 3] = MAXU
    rd[:, 4] = np.uint32(0xFFFF)
    keep = S + c_wide
    want = jx.rank_merge_round_d0(*(jnp.asarray(x) for x in
                                    (fi, fd, fq, ri, rd)), keep)
    got = tx.rank_merge_round_d0(*(to_torch(x) for x in
                                   (fi, fd, fq, ri, rd)), keep)
    assert_same(want, got, f"boundary C={c_wide}")
    assert int((got[0][:, -16:] >= 0).sum()) > 0


# ---------------------------------------------------------------------------
# off the engine's path: xor_ids, common bits, the plane k-closest,
# lex_searchsorted and the exact 5-limb merge
# ---------------------------------------------------------------------------

def test_xor_ids_and_common_bits():
    assert (tx.HASH_BITS, tx.SENTINEL_LIMB) == (jx.HASH_BITS,
                                                int(jx.SENTINEL_LIMB))
    a, b = _ids(20, 300), _ids(21, 300)
    b[:40] = a[:40]                                  # equal: 160
    for i in range(5):                               # first diff in limb i
        rows = slice(40 + 40 * i, 80 + 40 * i)
        b[rows, :i] = a[rows, :i]
        b[rows, i] = a[rows, i] ^ (np.uint32(1) << np.uint32(
            np.arange(40) % 32))[:40]
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), to_torch(a), to_torch(b)
    assert_same([jx.xor_ids(ja, jb)], [tx.xor_ids(ta, tb)], "xor_ids")
    assert_same([jx.xor_ids(ja, jb[0])], [tx.xor_ids(ta, tb[0])],
                "xor_ids broadcast")
    want = np.asarray(jx.common_bits(ja, jb))
    got = tx.common_bits(ta, tb)
    assert got.dtype.is_signed and np.array_equal(want, got.numpy())
    assert set(got[:40].tolist()) == {160} and got.min() < 32
    w32 = np.asarray(jx.common_bits32(ja[:, 0], jb[:, 0]))
    assert np.array_equal(w32, tx.common_bits32(ta[:, 0], tb[:, 0]).numpy())


@pytest.mark.parametrize("valid", ["all", "most", "few"])
def test_closest_nodes_batched_plane(valid):
    """The plane k-closest equals JAX's, ties and the excluded rows'
    all-ones sentinel included: with fewer valid rows than the
    prefilter, excluded rows reach the shortlist as -1 at the
    sentinel's distance (not last, as the K3 kernel ranks them)."""
    r = np.random.default_rng(22)
    ids = _ids(23, 400)
    ids[100:140, 0] = ids[0, 0]                      # first-limb ties
    ids[200, 0] = 0xFFFFFFFF
    tg = _ids(24, 24)
    tg[:4, 0] = 0                                    # d0 all-ones at row 200
    few = np.zeros(400, bool)
    few[r.choice(400, 5, replace=False)] = True      # fewer than k
    mask = {"all": None, "most": r.random(400) < 0.9, "few": few}[valid]
    jv = None if mask is None else jnp.asarray(mask)
    tv = None if mask is None else to_torch(mask)
    for k, pre in ((8, 32), (3, 16)):
        want = jx.closest_nodes_batched_plane(jnp.asarray(ids),
                                              jnp.asarray(tg), k, pre,
                                              valid=jv)
        got = tx.closest_nodes_batched_plane(to_torch(ids), to_torch(tg), k,
                                             pre, valid=tv)
        assert_same([want], [got], f"plane k={k} valid={valid}")
    if valid == "few":
        # The sentinel: excluded rows sort at the all-ones id's distance,
        # so they can push valid rows past k, where the exact-k kernel's
        # plain version ranks every excluded row last.
        from opendht_tpu_torch.ops import kernels
        got = tx.closest_nodes_batched_plane(to_torch(ids), to_torch(tg), 8,
                                             32, valid=tv)
        exact = kernels.nearest_k_ids(to_torch(ids), to_torch(tg), 8,
                                      valid=tv)
        assert bool(((exact >= 0).sum(1) == 5).all())
        assert bool(((got >= 0).sum(1) < 5).any())
        for a, b in zip(got.tolist(), exact.tolist()):
            assert {x for x in a if x >= 0} <= set(b)


@pytest.mark.parametrize("side", ["left", "right"])
def test_lex_searchsorted(side):
    raw = _ids(25, 257)
    raw[10:20] = raw[9]                              # duplicate ids
    srt = np.asarray(jnp.stack(jax.lax.sort(
        tuple(jnp.asarray(raw[:, i]) for i in range(5)), num_keys=5), -1))
    q = np.concatenate([srt[::7], _ids(26, 40),
                        np.zeros((1, 5), np.uint32),
                        np.full((1, 5), 0xFFFFFFFF, np.uint32)])
    want = jx.lex_searchsorted(jnp.asarray(srt), jnp.asarray(q), side)
    got = tx.lex_searchsorted(to_torch(srt), to_torch(q), side)
    assert_same([want], [got], f"lex_searchsorted {side}")
    one = srt[:1]
    assert_same([jx.lex_searchsorted(jnp.asarray(one), jnp.asarray(q), side)],
                [tx.lex_searchsorted(to_torch(one), to_torch(q), side)],
                "one row")


@pytest.mark.parametrize("seed", range(2))
def test_merge_shortlists_exact(seed):
    r = np.random.default_rng(30 + seed)
    ids = _ids(31 + seed, 16 * 40).reshape(16, 40, 5)
    ids[:, 5:10] = ids[:, 0:5]                       # duplicate ids
    idx = r.integers(0, 1000, (16, 40)).astype(np.int32)
    idx[:, 5:10] = idx[:, 0:5]
    idx[r.random((16, 40)) < 0.2] = -1
    q = r.random((16, 40)) < 0.3
    tg = _ids(33, 16)
    for keep in (14, 40):
        want = jx.merge_shortlists(jnp.asarray(tg), jnp.asarray(ids),
                                   jnp.asarray(idx), jnp.asarray(q), keep)
        got = tx.merge_shortlists(to_torch(tg), to_torch(ids), to_torch(idx),
                                  to_torch(q), keep)
        assert_same(want, got, f"merge_shortlists keep={keep}")
