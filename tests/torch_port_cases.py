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


def fused_case(name, seed, a=FA, k=FK):
    """Named K2 input cases (numpy), all at one shape (``a``
    solicitations of ``k``-member buckets; past ``S`` solicitations the
    rest have no slot): ``(tables, targets0, fr_idx, fr_d0, fr_q,
    safe_sel, sel_d0, sel_pos, w0, q_hit, e_hit)``.

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
    tables = fused_tables(seed, k=k)
    fi, fd, fq = make_frontier(seed, l=FL)
    targets0 = r.integers(0, 2**32, FL, dtype=np.uint32)
    safe_sel = r.integers(0, FN, (FL, a), dtype=np.int32)
    sel_d0 = (r.integers(0, 2**32, (FL, a), dtype=np.uint32)
              >> r.integers(0, 6, (FL, a)).astype(np.uint32))
    clz = np.array([[32 - int(v).bit_length() for v in row]
                    for row in sel_d0])
    w0 = np.clip(clz, 0, F_BUCKETS - 2).astype(np.int32)
    sel_pos = np.argsort(r.random((FL, max(S, a))),
                         axis=1)[:, :a].astype(np.int32)
    sel_pos[(sel_pos >= S) | (r.random((FL, a)) < 0.1)] = -1
    u = r.random((FL, a))
    q_hit, e_hit = u < 0.6, (u >= 0.6) & (u < 0.8)
    if name == "invalid_dead":
        q_hit[:32], e_hit[:32], sel_pos[:32] = False, False, -1
        q_hit[32:64], e_hit[32:64] = False, True
        q_hit[64:96], e_hit[64:96], sel_pos[64:96] = True, False, -1
    elif name == "w0_edges":
        edges = np.array([0, F_BUCKETS - 2, F_BTOTAL - 2, F_BTOTAL - 1,
                          F_BTOTAL + 3, 31, 40, -1], np.int32)
        w0 = edges[r.integers(0, len(edges), (FL, a))]
        q_hit[:, :] = True
    elif name == "frontier_dups":
        q_hit[:, :] = True
        mem = window_members(tables, safe_sel, w0, k).reshape(FL, -1)
        for li in range(FL):
            cand = [m for m in dict.fromkeys(mem[li].tolist()) if m >= 0]
            cand = [m for m in cand if m not in fi[li]][:3]
            slots = r.permutation(np.flatnonzero(fi[li] >= 0))
            for j, m in zip(slots, cand):   # valid slots: order kept
                fi[li, j] = m
    return (tables, targets0, fi, fd, fq, safe_sel, sel_d0, sel_pos, w0,
            q_hit, e_hit)


# ---------------------------------------------------------------------------
# integrity, chunked values and serving: one swarm, one schedule
# ---------------------------------------------------------------------------
#
# The three files share a 512-node swarm (the JAX package builds it from
# PRNGKey(0), as ``test_torch_storage.py``'s does), one slot width and
# one admission cap, so the JAX programs compile once per shape.  JAX is
# imported inside these helpers only.

SERVE_N = 512
SERVE_SLOTS, SERVE_ADMIT = 64, 32


def jax_swarm(n=SERVE_N, seed=0):
    """The JAX package's swarm and config at ``n`` nodes (cached)."""
    key = (n, seed)
    if key not in _JAX_SWARMS:
        import jax
        from opendht_tpu.models import swarm as jsw
        cfg = jsw.SwarmConfig.for_nodes(n)
        _JAX_SWARMS[key] = (jsw.build_swarm(jax.random.PRNGKey(seed), cfg),
                            cfg)
    return _JAX_SWARMS[key]


_JAX_SWARMS: dict = {}


def port_swarm(sw):
    """A JAX swarm carried to the port on the CPU."""
    from opendht_tpu_torch.convert import swarm_from_numpy
    return swarm_from_numpy(np.asarray(sw.ids), np.asarray(sw.tables),
                            np.asarray(sw.alive), device="cpu")


def port_cfg(cfg):
    """The port's SwarmConfig equal to a JAX one (``merge_impl`` maps
    JAX's ``"pallas-round"`` to the port's ``"fused-round"``)."""
    from opendht_tpu_torch.models.swarm import SwarmConfig
    kw = cfg._asdict()
    if kw["merge_impl"] == "pallas-round":
        kw["merge_impl"] = "fused-round"
    elif kw["merge_impl"] not in ("auto", "sort", "fused-round"):
        kw["merge_impl"] = "auto"
    return SwarmConfig(**kw)


def jax_origins(sw, key, l):
    """JAX's origin draw ``_sample_origins(key, alive, l)`` as a
    tensor (what ``lookup(…, key)`` and the serve admissions use)."""
    from opendht_tpu.models import swarm as jsw
    return torch.from_numpy(np.array(jsw._sample_origins(key, sw.alive, l)))


def jax_admission_origins(sw, key, a=SERVE_ADMIT):
    """The serve loop's ``origins_of`` hook giving admission ``i`` JAX's
    draw ``_sample_origins(fold_in(key, i), alive, a)``."""
    import jax
    memo = {}

    def origins_of(i):
        if i not in memo:
            memo[i] = jax_origins(sw, jax.random.fold_in(key, i), a)
        return memo[i]
    return origins_of


def jax_key_pool(seed, key_pool):
    """``poisson_zipf_events``' key pool as the JAX package draws it."""
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.random.bits(jax.random.PRNGKey(seed ^ 0x5EED),
                                      (key_pool, 5), jnp.uint32))


def serve_schedule(rate=400.0, duration=0.5, key_pool=64, zipf_s=1.1,
                   seed=5):
    """One open-loop schedule from the JAX package: ``(arrival_ts, keys,
    klass)`` and the key pool it drew."""
    from opendht_tpu.models.serve import poisson_zipf_events
    ts, keys, klass = poisson_zipf_events(rate=rate, duration=duration,
                                          key_pool=key_pool, zipf_s=zipf_s,
                                          seed=seed)
    return (ts, np.asarray(keys), klass), jax_key_pool(seed, key_pool)


# Keys of the port's serve report that the JAX report lacks: the found
# heads beside ``request``, and host walls (not a function of the schedule).
PORT_REPORT_KEYS = {"found", "layer_walls_s"}


def assert_reports_same(rj, rt, what):
    """Every key of JAX's serve report equal in the port's: arrays element
    for element, scalars and the burst marks exactly (floats included).
    The port's own keys are exactly ``PORT_REPORT_KEYS``, and its found
    heads agree with JAX's ``found_nonempty``."""
    assert set(rt) - set(rj) == PORT_REPORT_KEYS, what
    assert set(rj) <= set(rt), what
    found = rt["found"]
    assert found.dtype == np.int32 and len(found) == rt["completed"], what
    assert np.array_equal(found[:, 0] >= 0, rj["found_nonempty"]), what
    for k in rj:
        a, b = rj[k], rt[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype, f"{what}: {k} dtype"
            assert np.array_equal(a, np.asarray(b)), f"{what}: {k}"
        else:
            assert a == b, f"{what}: {k} {a!r} != {b!r}"


# ---------------------------------------------------------------------------
# the PHT index: one batch shape for JAX
# ---------------------------------------------------------------------------

def patch_index_widths(mp, width):
    """Pad every index store batch of both packages to ``width`` rows
    (wider batches keep their own power of two), and run JAX's trie-node
    hash at one shape, ``[width, PW]`` (its SHA-1 unroll otherwise
    compiles once per batch shape).  ``mp`` is a ``MonkeyPatch``."""
    import jax.numpy as jnp
    from opendht_tpu.models import index as ji
    from opendht_tpu_torch.models import index as ti
    from opendht_tpu_torch.models.storage import pow2_width
    hash_j = ji._trie_node_hash

    def padded_hash(spec, bits, depth):
        m = bits.shape[0]
        if bits.ndim != 2 or m > width:
            return hash_j(spec, bits, depth)
        pad = width - m
        out = hash_j(spec, jnp.pad(jnp.asarray(bits), ((0, pad), (0, 0))),
                     jnp.pad(jnp.asarray(depth), (0, pad)))
        return out[:m]
    mp.setattr(ji, "_trie_node_hash", padded_hash)
    for mod in (ji, ti):
        mp.setattr(mod, "_pow2_width",
                   lambda m, floor=16: max(width, pow2_width(m, floor)))
