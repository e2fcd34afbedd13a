"""K1 (round merge) and K3 (exact k-nearest): the plain versions against
the JAX Pallas kernels (interpret mode) and brute force, bit for bit;
the CUDA kernels — K1, K2 (the fused round), K3 and K3′ — against the
plain versions on the card.  (K2's and K3′'s plain versions are held
against JAX in ``test_torch_fused_round.py``.)

JAX is imported inside the tests that compare with it, so the card-only
tests (marker ``cuda``) also run where JAX is not installed:
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.
"""

import numpy as np
import pytest

import torch

from opendht_tpu_torch.ops import kernels

from torch_port_cases import (C, FA, FK, FUSED_CASES, L, MAXU, S,
                              adversarial_responses, assert_same, fused_case,
                              make_frontier, to_torch)

QUORUM = 8


def _merge_case(name, seed=0):
    """Named K1 input cases (numpy): the documented corner rules."""
    fi, fd, fq = make_frontier(seed)
    ri, rd = adversarial_responses(2000 + seed, fi)
    if name == "frontier_dup":          # a response names a frontier node
        fi, fd, fq = make_frontier(seed, evict_frac=0.0)
        ri = np.full((L, C), -1, np.int32)
        ri[:, 0] = np.where(fi[:, 0] >= 0, fi[:, 0], 0)
        rd = np.zeros((L, C), np.uint32)            # claims distance 0
    elif name == "live_sentinel":       # live d0 == 0xFFFFFFFF
        fi = np.full((L, S), -1, np.int32)
        fd = np.full((L, S), MAXU)
        fq = np.zeros((L, S), bool)
        ri = np.full((L, C), -1, np.int32)
        ri[:, 3], ri[:, 9] = 7, 11
        rd = np.full((L, C), MAXU)
    elif name == "all_invalid":
        fi[:8], fd[:8] = -1, MAXU
        ri[:4] = -1
    elif name == "dup_before_live_sentinel":
        # A response repeats frontier node x (small idx), and a live
        # response y > x has d0 all-ones: the duplicate's key (all-ones,
        # x) ranks before y, so its fill slot lands mid-row, before y.
        r = np.random.default_rng(seed)
        x = r.integers(0, 100, L).astype(np.int32)
        y = x + r.integers(1, 100, L).astype(np.int32)
        fi = np.full((L, S), -1, np.int32)
        fd = np.full((L, S), MAXU)
        fi[:, 0], fd[:, 0] = x, r.integers(0, 2**31, L, dtype=np.uint32)
        fq = np.zeros((L, S), bool)
        fq[::2, 0] = True
        ri = np.full((L, C), -1, np.int32)
        rd = r.integers(0, 2**32, (L, C), dtype=np.uint32)
        ri[:, 1], ri[:, 4], ri[:, 7] = x, y, y    # y's repeat: a fill too
        rd[:, 4] = MAXU
    return fi, fd, fq, ri, rd


MERGE_CASES = [("adversarial", 0, S), ("adversarial", 1, S),
               ("adversarial", 2, 3), ("frontier_dup", 4, S),
               ("live_sentinel", 0, S), ("all_invalid", 3, S),
               ("adversarial", 6, S + C + 5),
               ("dup_before_live_sentinel", 5, S)]


@pytest.mark.parametrize("name,seed,keep", MERGE_CASES)
def test_merge_round_plain_matches_pallas(name, seed, keep):
    import jax.numpy as jnp
    from opendht_tpu.ops.pallas_kernels import merge_round_pallas
    from opendht_tpu.ops.xor_metric import rank_merge_round_d0
    case = _merge_case(name, seed)
    want = merge_round_pallas(*(jnp.asarray(x) for x in case),
                              quorum=QUORUM, keep=keep, interpret=True)
    got = kernels.merge_round(*(to_torch(x) for x in case), quorum=QUORUM,
                              keep=keep)
    assert_same(want, got, f"merge_round {name} seed={seed} keep={keep}")
    # ... and the first three outputs equal the JAX rank merge.
    ref = rank_merge_round_d0(*(jnp.asarray(x) for x in case), keep)
    assert_same(ref, got[:3], f"rank merge {name}")


def test_merge_round_live_sentinel_order():
    got = kernels.merge_round(*(to_torch(x) for x in
                                _merge_case("live_sentinel")),
                              quorum=QUORUM, keep=S)
    assert got[0][0, :2].tolist() == [7, 11]


def test_merge_round_fill_slot_lands_mid_row():
    fi, fd, fq, ri, rd = _merge_case("dup_before_live_sentinel", 5)
    got = kernels.merge_round(*(to_torch(x) for x in (fi, fd, fq, ri, rd)),
                              quorum=QUORUM, keep=S)
    assert got[0][:, :4].tolist() == [[x, -1, y, -1] for x, y in
                                      zip(fi[:, 0].tolist(), ri[:, 4].tolist())]
    assert (got[1][:, 1] == 0xFFFFFFFF).all() and not got[2][:, 1].any()
    assert got[2][:, 0].tolist() == fq[:, 0].tolist()


def _ids(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 5),
                                                dtype=np.uint32)


def brute_closest(ids, target, k, valid=None):
    """Ground truth via Python big-int XOR distances."""
    t = int.from_bytes(b"".join(int(x).to_bytes(4, "big") for x in target),
                       "big")
    keyed = []
    for i, row in enumerate(ids):
        if valid is not None and not valid[i]:
            continue
        v = int.from_bytes(b"".join(int(x).to_bytes(4, "big") for x in row),
                           "big")
        keyed.append((v ^ t, i))
    got = [i for _, i in sorted(keyed)[:k]]
    return got + [-1] * (k - len(got))


def _nearest_case(name):
    """Named K3 input cases (numpy).  All share one shape and always
    carry a mask, so the Pallas interpreter compiles once per k."""
    ids, tg = _ids(1, 700), _ids(2, 9)       # 700: not a tile multiple
    valid, k = np.ones(700, bool), 8
    if name == "high_bit":              # close to an all-ones pad value
        tg[:, 0] |= np.uint32(0xFFF00000)
    elif name == "valid_mask":
        valid[::3] = False
    elif name == "fewer_than_k":
        valid[:] = False
        valid[[3, 100, 250, 600, 699]] = True
    elif name == "k1":                  # a node is nearest to itself
        tg, k = ids[[0, 1, 2, 3, 699, 5, 6, 7, 8]], 1
    elif name == "sorted_ids":
        # Sorted as build_swarm sorts them (lexicographic on the limbs),
        # with targets that are ids and near-ids (a flipped low bit of
        # the last or the first limb): the nearest rows are neighbours.
        ids = ids[np.lexsort(ids.T[::-1])]
        tg[:3] = ids[[5, 350, 699]]
        tg[3:6] = ids[[10, 400, 650]] ^ np.array([0, 0, 0, 0, 1], np.uint32)
        tg[6:8] = ids[[0, 333]] ^ np.array([1, 0, 0, 0, 0], np.uint32)
        valid[::5] = False
    elif name == "duplicate_ids":
        # Ten copies of one id at rows on and off a 32- and a 64-row
        # stride (two masked), six of another: the k nearest tie on all
        # 160 bits, so the row index decides, at the bound itself.
        copies = [0, 32, 33, 64, 97, 128, 200, 201, 640, 699]
        ids[copies] = ids[0]
        valid[[33, 128]] = False
        ids[[300, 364, 365, 500, 512, 96]] = ids[300]
        tg[:3] = ids[[0, 300, 0]]
        tg[2, 4] ^= np.uint32(1)
        tg[3] = ids[300] ^ np.array([0, 0, 0, 1, 0], np.uint32)
    elif name == "shared_first_limb":
        # Rows that share their first limb and differ further on: ties
        # on the first distance limb, broken by the other four.
        ids[100:400, 0] = ids[np.arange(100, 400) % 7, 0]
        tg[:4] = ids[[101, 205, 3, 399]]
        tg[4:6] = ids[[2, 6]] ^ np.array([0, 1, 0, 0, 0], np.uint32)
    elif name == "sparse_valid":
        # One valid row in 64, none but row 64 on a 32-row stride: a
        # sample holds fewer than k valid rows while the rows hold more.
        valid[:] = False
        valid[np.arange(5, 700, 64)] = True
        valid[64] = True
    return ids, tg, valid, k


NEAREST_CASES = ["not_tile_multiple", "high_bit", "valid_mask",
                 "fewer_than_k", "k1", "sorted_ids", "duplicate_ids",
                 "shared_first_limb", "sparse_valid"]


@pytest.mark.parametrize("name", NEAREST_CASES)
def test_nearest_k_plain_matches_pallas_and_brute(name):
    import jax.numpy as jnp
    from opendht_tpu.ops.pallas_kernels import nearest_k_ids as jax_nearest_k
    ids, tg, valid, k = _nearest_case(name)
    want = np.asarray(jax_nearest_k(jnp.asarray(ids), jnp.asarray(tg), k,
                                    valid=jnp.asarray(valid), tile_l=16,
                                    tile_n=1024, interpret=True))
    got = kernels.nearest_k_ids(to_torch(ids), to_torch(tg), k,
                                valid=torch.from_numpy(valid))
    assert np.array_equal(want.astype(np.int64), got.numpy())
    for li in range(tg.shape[0]):
        assert got[li].tolist() == brute_closest(ids, tg[li], k, valid)
    if name == "k1":
        assert got[:, 0].tolist() == [0, 1, 2, 3, 699, 5, 6, 7, 8]
    if name == "fewer_than_k":
        assert (got[:, 5:] == -1).all()


def test_nearest_k_plain_without_mask():
    ids, tg, _, k = _nearest_case("high_bit")
    got = kernels.nearest_k_ids(to_torch(ids), to_torch(tg), k)
    for li in range(tg.shape[0]):
        assert got[li].tolist() == brute_closest(ids, tg[li], k)


def test_nearest_k_plain_chunking_is_exact():
    """Streaming over slices smaller than N changes nothing."""
    ids, tg = _ids(10, 1000), _ids(11, 7)
    ids[500:520] = ids[0:20]                 # duplicate ids: index tiebreak
    valid = torch.from_numpy(np.random.default_rng(0).random(1000) < 0.7)
    a = kernels.nearest_k_ids_plain(to_torch(ids), to_torch(tg), 8,
                                    valid=valid)
    b = kernels.nearest_k_ids_plain(to_torch(ids), to_torch(tg), 8,
                                    valid=valid, chunk=37)
    assert torch.equal(a, b)


def test_cpu_wrappers_count_no_launch():
    kernels.reset_launches()
    case = _merge_case("adversarial")
    kernels.merge_round(*(to_torch(x) for x in case), quorum=QUORUM, keep=S)
    kernels.fused_round(*(to_torch(x) for x in fused_case("round", 0)),
                        bucket_k=FK, quorum=QUORUM, keep=S)
    ids, tg, _, _ = _nearest_case("k1")
    kernels.nearest_k_ids(to_torch(ids), to_torch(tg), 8)
    kernels.nearest_ids(to_torch(ids), to_torch(tg))
    assert kernels.LAUNCHES == {"merge_round": 0, "fused_round": 0,
                                "nearest_k_ids": 0, "nearest_ids": 0}


def test_library_names_cover_the_shared_header(tmp_path, monkeypatch):
    """Each library is named after its source and every ``.cuh`` header:
    editing the merge core K1 and K2 share renames both libraries."""
    for f in kernels.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = {n: kernels.source_digest(src)
              for n, src in kernels.SOURCES.items()}
    core = tmp_path / "merge_core.cuh"
    core.write_text(core.read_text() + "\n// edited\n")
    after = {n: kernels.source_digest(src)
             for n, src in kernels.SOURCES.items()}
    assert after["merge_round"] != before["merge_round"]
    assert after["fused_round"] != before["fused_round"]
    assert '#include "merge_core.cuh"' in (
        tmp_path / "merge_round.cu").read_text()
    assert '#include "merge_core.cuh"' in (
        tmp_path / "fused_round.cu").read_text()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed,keep", MERGE_CASES)
def test_merge_round_kernel_matches_plain(name, seed, keep):
    dev = _need_card()
    case = _merge_case(name, seed)
    want = kernels.merge_round(*(to_torch(x) for x in case), quorum=QUORUM,
                               keep=keep)
    before = kernels.LAUNCHES["merge_round"]
    got = kernels.merge_round(*(to_torch(x, dev) for x in case),
                              quorum=QUORUM, keep=keep)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["merge_round"] == before + 1
    assert_same(want, got, f"K1 kernel {name}")


def _edge_case(c, seed, l=61):
    """K1 inputs at W = S + c over ``l`` rows (61: a multiple of neither
    the 8 or 16 rows a block takes nor the 2 a warp takes): adversarial
    rows, then frontier repeats with equal d0 and opposite queried flags
    (row 0), a row that is all duplicates (row 1), and a duplicate
    ranking before a live all-ones response (row 2)."""
    fi, fd, fq = make_frontier(seed, l=l, c=c)
    ri, rd = adversarial_responses(3000 + seed, fi, c=c)
    fi[0, :2], fd[0, :2], fq[0, :2] = 9, 77, [True, False]
    fi[1, :2], fd[1, :2] = [4, 6], [5, 6]
    ri[1] = np.where(np.arange(c) % 2, fi[1, 0], fi[1, 1])
    fi[2], fd[2] = -1, MAXU
    fi[2, 0], fd[2, 0] = 3, 1
    ri[2], rd[2] = -1, MAXU
    ri[2, 0], ri[2, 1] = 3, 8
    return fi, fd, fq, ri, rd


EDGE_CASES = [(c, keep)
              for c in (32, 64, 72, 114)           # W = 46, 78, 86, 128
              for keep in (1, 3, S, S + c, S + c + 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,keep", EDGE_CASES)
def test_merge_round_kernel_edges(c, keep):
    """W not a multiple of 32 (46, 78 on 16-lane row groups; 86 on a
    warp, three entries a lane) and exactly four entries a lane of a warp
    (128); keep 1, 3, S, W and past W."""
    dev = _need_card()
    case = _edge_case(c, seed=c + keep)
    want = kernels.merge_round(*(to_torch(x) for x in case), quorum=QUORUM,
                               keep=keep)
    got = kernels.merge_round(*(to_torch(x, dev) for x in case),
                              quorum=QUORUM, keep=keep)
    torch.cuda.synchronize()
    assert_same(want, got, f"K1 kernel W={S + c} keep={keep}")


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed,_", FUSED_CASES)
@pytest.mark.parametrize("a,k", [(1, FK), (FA, FK), (5, FK), (6, FK),
                                 (20, 1)])
@pytest.mark.parametrize("keep", [3, "w"])
def test_fused_round_kernel_row_groups(name, seed, _, a, k, keep):
    """K2 on every row group its launcher picks: W = 30 and 78 on
    16-lane groups, W = 94 and 110 on a warp (W > 80), and A = 20 > 16
    (K = 1, W = 54) on a warp; keep 3 and keep = W."""
    dev = _need_card()
    case = fused_case(name, seed, a=a, k=k)
    keep = S + 2 * k * a if keep == "w" else keep
    want = kernels.fused_round(*(to_torch(x) for x in case), bucket_k=k,
                               quorum=QUORUM, keep=keep)
    got = kernels.fused_round(*(to_torch(x, dev) for x in case), bucket_k=k,
                              quorum=QUORUM, keep=keep)
    torch.cuda.synchronize()
    assert_same(want, got, f"K2 kernel {name} A={a} K={k} keep={keep}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NEAREST_CASES)
def test_nearest_k_kernel_matches_plain(name):
    dev = _need_card()
    ids, tg, valid, k = _nearest_case(name)
    for vt in (torch.from_numpy(valid), None):
        want = kernels.nearest_k_ids(to_torch(ids), to_torch(tg), k,
                                     valid=vt)
        got = kernels.nearest_k_ids(to_torch(ids, dev), to_torch(tg, dev),
                                    k, valid=None if vt is None
                                    else vt.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(want, got.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed,keep", FUSED_CASES)
def test_fused_round_kernel_matches_plain(name, seed, keep):
    dev = _need_card()
    case = fused_case(name, seed)
    want = kernels.fused_round(*(to_torch(x) for x in case), bucket_k=FK,
                               quorum=QUORUM, keep=keep)
    before = kernels.LAUNCHES["fused_round"]
    got = kernels.fused_round(*(to_torch(x, dev) for x in case), bucket_k=FK,
                              quorum=QUORUM, keep=keep)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_round"] == before + 1
    assert_same(want, got, f"K2 kernel {name}")


@pytest.mark.cuda
def test_fused_round_kernel_64bit_offsets():
    """Solicited rows whose table offsets pass 2^31 elements (a
    [2^23 + 4096, 256] u16 table, 4.3 GB): the kernel addresses them in
    64 bits."""
    dev = _need_card()
    case = [to_torch(x, dev) for x in fused_case("round", 0)]
    n = (1 << 23) + 4096
    tables = torch.full((n, case[0].shape[1]), 0xFFFF, dtype=torch.uint16,
                        device=dev)
    tables[-case[0].shape[0]:] = case[0]            # the case's rows, last
    case[0] = tables
    case[5] = case[5] + (n - 512)                   # solicit those rows
    got = kernels.fused_round(*case, bucket_k=FK, quorum=QUORUM, keep=S)
    want = kernels.fused_round(*(to_torch(x) for x in fused_case("round", 0)),
                               bucket_k=FK, quorum=QUORUM, keep=S)
    torch.cuda.synchronize()
    assert_same(want, got, "K2 past 2^31 elements")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NEAREST_CASES)
def test_nearest_ids_kernel_matches_plain(name):
    dev = _need_card()
    ids, tg, _, _ = _nearest_case(name)
    want = kernels.nearest_ids(to_torch(ids), to_torch(tg))
    before = kernels.LAUNCHES["nearest_ids"]
    got = kernels.nearest_ids(to_torch(ids, dev), to_torch(tg, dev))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["nearest_ids"] == before + 1
    assert torch.equal(want, got.cpu())


def _nearest_sizes_case(n, l, seed):
    """K3 inputs of ``n`` random ids (some duplicated, more sharing their
    first limb with another) and ``l`` targets, some of them ids, and a
    mask with a quarter of the rows invalid."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, 2**32, (n, 5), dtype=np.uint32)
    ids[r.integers(0, n, n // 100)] = ids[r.integers(0, n, n // 100)]
    ids[r.integers(0, n, n // 10), 0] = ids[r.integers(0, n, n // 10), 0]
    tg = r.integers(0, 2**32, (l, 5), dtype=np.uint32)
    tg[: l // 4] = ids[r.integers(0, n, l // 4)]
    return ids, tg, r.random(n) >= 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("masked", [True, False])
def test_nearest_k_kernel_many_chunks_and_groups(k, masked):
    """70,000 nodes x 1,100 targets: several target groups, node chunks
    and sample chunks for every k the list sizes take."""
    dev = _need_card()
    ids, tg, valid = _nearest_sizes_case(70_000, 1_100, seed=k)
    ids_d, tg_d = to_torch(ids, dev), to_torch(tg, dev)
    v = torch.from_numpy(valid).to(dev) if masked else None
    want = kernels.nearest_k_ids_plain(ids_d, tg_d, k, valid=v, chunk=4096)
    got = kernels.nearest_k_ids(ids_d, tg_d, k, valid=v)
    torch.cuda.synchronize()
    assert torch.equal(want, got)
    if k == 1 and not masked:
        got1 = kernels.nearest_ids(ids_d, tg_d)
        torch.cuda.synchronize()
        assert torch.equal(want[:, 0], got1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1, 1), (5, 8), (3, 16), (12, 16)])
def test_nearest_k_kernel_fewer_rows_than_k(n, k):
    dev = _need_card()
    ids, tg, valid = _nearest_sizes_case(n, 40, seed=n)
    for v in (torch.from_numpy(valid), None):
        want = kernels.nearest_k_ids(to_torch(ids), to_torch(tg), k, valid=v)
        got = kernels.nearest_k_ids(to_torch(ids, dev), to_torch(tg, dev), k,
                                    valid=None if v is None else v.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(want, got.cpu())
        assert (got[:, n:] == -1).all()


@pytest.mark.cuda
def test_nearest_k_kernel_every_row_masked():
    dev = _need_card()
    ids, tg, _ = _nearest_sizes_case(5_000, 300, seed=3)
    none = torch.zeros(5_000, dtype=torch.bool, device=dev)
    got = kernels.nearest_k_ids(to_torch(ids, dev), to_torch(tg, dev), 8,
                                valid=none)
    torch.cuda.synchronize()
    assert (got == -1).all()


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_input():
    dev = _need_card()
    fi = torch.zeros((4, S), dtype=torch.int64, device=dev)    # not int32
    with pytest.raises(TypeError):
        kernels.merge_round(fi, fi, fi.bool(), fi, fi, quorum=8, keep=S)
    case = [to_torch(x, dev) for x in fused_case("round", 0)]
    case[7] = case[7].to(torch.int64)                          # sel_pos
    with pytest.raises(TypeError, match="sel_pos"):
        kernels.fused_round(*case, bucket_k=FK, quorum=QUORUM, keep=S)
    # Rows of W = 129 > MERGE_MAX_W entries: S = 14 + C = 115 for K1,
    # S = 1 + 2·K·A = 128 (K = 8, A = 8) for K2.
    fi = torch.zeros((4, S), dtype=torch.int32, device=dev)
    ri = torch.zeros((4, 115), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="S\\+C <= 128"):
        kernels.merge_round(fi, fi.long(), fi.bool(), ri, ri.long(),
                            quorum=8, keep=S)
    z = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    f1 = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    tables = torch.zeros((16, 256), dtype=torch.uint16, device=dev)
    with pytest.raises(ValueError, match="S\\+2KA <= 128"):
        kernels.fused_round(tables, f1[:, 0].long(), f1, f1.long(),
                            f1.bool(), z, z.long(), z, z, z.bool(), z.bool(),
                            bucket_k=8, quorum=8, keep=S)


def _chaos_rounds(dev, eclipse, defend, drop, rounds=4, n=4096, l=1024):
    """K1's inputs of the first ``rounds`` rounds of a chaos lookup on the
    card (10 % Byzantine, 10 % dead): undefended rounds hand the merge
    rows full of poisoned candidates claimed near zero (under eclipse,
    colluder ids repeating across a row, dead ones among them);
    defended ones rows whose rejected candidates became -1 / all-ones in
    place, mid-row."""
    from opendht_tpu_torch.models import swarm as sw
    cfg = sw.SwarmConfig.for_nodes(n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    swarm = sw.build_swarm(cfg, gen, device=dev)
    swarm = sw.churn(sw.corrupt_swarm(swarm, gen, 0.1, cfg), gen, 0.1, cfg)
    faults = sw.LookupFaults(drop_frac=drop, eclipse=eclipse, seed=7,
                             defend=defend)
    tg = torch.randint(0, 2**32, (l, 5), generator=gen, device=dev)
    origins = sw._sample_origins(gen, swarm.alive & ~swarm.byzantine, l)
    st = sw.chaos_lookup_init(swarm, cfg, tg, origins)
    strikes = torch.zeros((n,), dtype=torch.int32, device=dev)
    aux = sw.byz_colluder_pool(swarm.byzantine) if eclipse else None
    out = []
    for r in range(rounds):
        out.append(sw.chaos_round_inputs(swarm, cfg, faults, st, strikes, r,
                                         aux)[3])
        st, strikes = sw.chaos_lookup_step(swarm, cfg, faults, st, strikes,
                                           r, aux)
    return out


CHAOS_ROUNDS = [("eclipse_undefended", True, False, 0.0),
                ("random_undefended", False, False, 0.0),
                ("eclipse_defended", True, True, 0.0),
                ("random_defended_drop", False, True, 0.3)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,eclipse,defend,drop", CHAOS_ROUNDS)
def test_merge_round_kernel_on_chaos_rounds(name, eclipse, defend, drop):
    """K1 against its plain version on four adversarial rounds each."""
    dev = _need_card()
    near_zero = holes = 0
    for r, args in enumerate(_chaos_rounds(dev, eclipse, defend, drop)):
        got = kernels.merge_round(*args, quorum=QUORUM, keep=S)
        want = kernels.merge_round(*(a.cpu() for a in args), quorum=QUORUM,
                                   keep=S)
        torch.cuda.synchronize()
        assert_same(want, got, f"K1 {name} round {r}")
        ri, rd = args[3], args[4]
        near_zero += int(((ri >= 0) & (rd < 2**15)).sum())
        blocks = ri.view(ri.shape[0], -1, 8)
        holes += int(((blocks < 0).any(-1) & (blocks >= 0).any(-1)).sum())
    if defend:
        assert holes > 0
    else:
        assert near_zero > 0
