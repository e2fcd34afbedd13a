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

from torch_port_cases import (C, FK, FUSED_CASES, L, MAXU, S,
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
    return fi, fd, fq, ri, rd


MERGE_CASES = [("adversarial", 0, S), ("adversarial", 1, S),
               ("adversarial", 2, 3), ("frontier_dup", 4, S),
               ("live_sentinel", 0, S), ("all_invalid", 3, S),
               ("adversarial", 6, S + C + 5)]


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
    return ids, tg, valid, k


NEAREST_CASES = ["not_tile_multiple", "high_bit", "valid_mask",
                 "fewer_than_k", "k1"]


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
