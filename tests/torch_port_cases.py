"""Shared inputs for the torch-port tests: the round-merge input
generators of ``tests/test_merge_equivalence.py`` (copied, so the port's
tests do not depend on that module) and numpy ↔ torch helpers.

The same numpy data goes through the JAX function and its port; every
comparison is exact (integers only, tolerance 0).  This module imports
no JAX, so the card-only tests that use it also run where JAX is not
installed: the frontier generator merges with the port's
``merge_shortlists_d0``, which ``test_torch_xor_metric.py`` holds
bit-equal to the JAX function.
"""

import numpy as np
import torch

from opendht_tpu_torch.ops.xor_metric import merge_shortlists_d0

L, S, C, NN = 64, 14, 32, 500
MAXU = np.uint32(0xFFFFFFFF)


def make_frontier(seed, evict_frac=0.25, l=L, s=S, c=C):
    """A frontier satisfying the round invariant: the output of the
    reference merge on random candidates (valid prefix sorted and
    dup-free), then eviction holes punched the way the round punches
    them (idx -1, d0 all-ones, queried flag kept)."""
    r = np.random.default_rng(seed)
    cd0 = r.integers(0, 2**32, (l, s + c), dtype=np.uint32)
    ci = r.integers(-1, NN, (l, s + c), dtype=np.int32)
    cq = (r.random((l, s + c)) < 0.5) & (ci >= 0)
    fi, fd, fq = (x.numpy() for x in merge_shortlists_d0(
        to_torch(cd0), to_torch(ci), to_torch(cq), keep=s))
    ev = r.random((l, s)) < evict_frac
    return (np.where(ev, -1, fi).astype(np.int32),
            np.where(ev, MAXU, fd).astype(np.uint32), fq.copy())


def adversarial_responses(seed, fi, c=C):
    """Responses hitting every documented corner: frontier duplicates
    with different d0s, a within-block duplicate, exact-sentinel d0
    live candidates, and invalid slots."""
    r = np.random.default_rng(seed)
    l, s = fi.shape
    ri = r.integers(-1, NN, (l, c), dtype=np.int32)
    take = r.integers(0, s, (l, c // 4))
    ri[:, :c // 4] = np.asarray(fi)[np.arange(l)[:, None], take]
    ri[:, c // 2] = ri[:, c // 2 + 1]         # within-block duplicate
    rd = r.integers(0, 2**32, (l, c), dtype=np.uint32)
    rd[:, 5] = MAXU                           # live sentinel-d0 rows
    return ri, rd


def to_torch(x, device="cpu"):
    """numpy → torch: uint32 widens to int64, everything else as is."""
    x = np.array(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(x).to(device)


def as_int64(x):
    """A JAX array, numpy array or tensor as an int64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def assert_same(jax_out, torch_out, what):
    """Exact equality, output by output (``None`` entries — unset
    optional fields — are skipped on both sides)."""
    jax_out = [x for x in jax_out if x is not None]
    torch_out = [x for x in torch_out if x is not None]
    assert len(jax_out) == len(torch_out), what
    for i, (a, b) in enumerate(zip(jax_out, torch_out)):
        a, b = as_int64(a), as_int64(b)
        assert a.shape == b.shape, f"{what}: output {i} shape"
        assert np.array_equal(a, b), f"{what}: output {i} diverged"


# ---------------------------------------------------------------------------
# K2 (the fused round): named cases on one shape
# ---------------------------------------------------------------------------

FN, FL, FA, FK = 512, 128, 4, 8   # nodes, lookup rows, alpha, bucket K
F_ROW_W = 256                     # pad128(6 buckets x 3K): b_total = 10
F_BUCKETS = 6                     # buckets filled; the rest is row pad
F_BTOTAL = F_ROW_W // (3 * FK)
FUSED_CASES = [("round", 0, S), ("invalid_dead", 1, S), ("w0_edges", 2, S),
               ("frontier_dups", 3, S), ("round", 4, 5)]


def fused_tables(seed, n=FN, row_w=F_ROW_W, buckets=F_BUCKETS, k=FK):
    """Augmented table rows ``[n, row_w]`` u16: per filled bucket K
    member indices (some empty: 0xFFFF halves) and their 16-bit
    windows; the row pad past the filled buckets stays 0xFFFF."""
    r = np.random.default_rng(seed)
    t = np.full((n, row_w), 0xFFFF, np.uint16)
    for b in range(buckets):
        idx = r.integers(0, n, (n, k)).astype(np.uint32)
        idx[r.random((n, k)) < 0.15] = 0xFFFFFFFF
        s16 = r.integers(0, 2**16, (n, k), dtype=np.uint32)
        row = np.concatenate([idx & 0xFFFF, idx >> 16, s16], axis=1)
        t[:, b * 3 * k:(b + 1) * 3 * k] = row.astype(np.uint16)
    return t


def window_members(tables, sel, w0, k=FK):
    """The decoded member indices ``[L,A,2K]`` (int32, -1 empty) of the
    bucket-pair windows K2 reads for ``sel``/``w0`` ``[L,A]``, with the
    Pallas select chain's fall-through to window 0."""
    b_total = tables.shape[1] // (3 * k)
    start = np.where((w0 >= 1) & (w0 <= b_total - 2), w0, 0)
    cols = (start * 3 * k)[..., None] + np.arange(6 * k)
    win = tables[sel[..., None], cols].astype(np.uint32)     # [L,A,6K]
    out = []
    for rr in (0, 1):
        lo = win[..., rr * 3 * k:rr * 3 * k + k]
        hi = win[..., rr * 3 * k + k:rr * 3 * k + 2 * k]
        out.append((lo | (hi << 16)).view(np.int32))
    return np.concatenate(out, axis=-1)


def fused_case(name, seed):
    """Named K2 input cases (numpy), all at one shape: ``(tables,
    targets0, fr_idx, fr_d0, fr_q, safe_sel, sel_d0, sel_pos, w0, q_hit,
    e_hit)``.

    * ``round`` — a prelude as the engine makes it: w0 = clip(clz(sel
      d0), 0, B-2) with spread distances, distinct slots, answered /
      dead / idle solicitations;
    * ``invalid_dead`` — rows whose solicitations are all idle (q_hit
      false: members masked), all dead (e_hit: frontier evictions),
      and answered ones with ``sel_pos = -1`` (no slot to mark);
    * ``w0_edges`` — w0 at 0, at B-2, in the row pad (b_total-2) and
      past b_total-2 (window 0 read, raw w0 decoded), and negative;
    * ``frontier_dups`` — responses that repeat frontier nodes (valid
      frontier slots renamed to members of the solicited windows, so
      the frontier stays sorted and duplicate-free, the round's
      contract)."""
    r = np.random.default_rng(100 + seed)
    tables = fused_tables(seed)
    fi, fd, fq = make_frontier(seed, l=FL)
    targets0 = r.integers(0, 2**32, FL, dtype=np.uint32)
    safe_sel = r.integers(0, FN, (FL, FA), dtype=np.int32)
    sel_d0 = (r.integers(0, 2**32, (FL, FA), dtype=np.uint32)
              >> r.integers(0, 6, (FL, FA)).astype(np.uint32))
    clz = np.array([[32 - int(v).bit_length() for v in row]
                    for row in sel_d0])
    w0 = np.clip(clz, 0, F_BUCKETS - 2).astype(np.int32)
    sel_pos = np.argsort(r.random((FL, S)), axis=1)[:, :FA].astype(np.int32)
    sel_pos[r.random((FL, FA)) < 0.1] = -1
    u = r.random((FL, FA))
    q_hit, e_hit = u < 0.6, (u >= 0.6) & (u < 0.8)
    if name == "invalid_dead":
        q_hit[:32], e_hit[:32], sel_pos[:32] = False, False, -1
        q_hit[32:64], e_hit[32:64] = False, True
        q_hit[64:96], e_hit[64:96], sel_pos[64:96] = True, False, -1
    elif name == "w0_edges":
        edges = np.array([0, F_BUCKETS - 2, F_BTOTAL - 2, F_BTOTAL - 1,
                          F_BTOTAL + 3, 31, 40, -1], np.int32)
        w0 = edges[r.integers(0, len(edges), (FL, FA))]
        q_hit[:, :] = True
    elif name == "frontier_dups":
        q_hit[:, :] = True
        mem = window_members(tables, safe_sel, w0).reshape(FL, -1)
        for li in range(FL):
            cand = [m for m in dict.fromkeys(mem[li].tolist()) if m >= 0]
            cand = [m for m in cand if m not in fi[li]][:3]
            slots = r.permutation(np.flatnonzero(fi[li] >= 0))
            for j, m in zip(slots, cand):   # valid slots: order kept
                fi[li, j] = m
    return (tables, targets0, fi, fd, fq, safe_sel, sel_d0, sel_pos, w0,
            q_hit, e_hit)
