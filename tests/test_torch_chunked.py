"""The port's chunked values against the JAX package's, bit for bit, on
one 512-node swarm: the hash-list ids and helpers, announce → get of
variable lengths (zero and over-long included) with verify off and on,
churn + republish, torn writes (a part-0-only overwrite, a writer killed
between parts, dropped parts) that read as missing, a forged part
rejected by the verified read with exact trace conservation, and
listen → collect → ack → re-deliver → cancel.  Beside them, the
integrity plane on plain values: payloads forged by ``forge_payloads``
(JAX's draws) rejected at insert with exact conservation, and forged
replicas discarded by the verified get.  After every step every
store field, the ``StoreTrace``, the reports and the results are
compared exactly; JAX's origins are handed across.

JAX's hash-list root over several SHA-1 blocks takes about 17 s to
compile on this CPU, so it is compared with the port's once, op by op
(``jax.disable_jit``); inside the composed JAX reads the root check
runs through JAX's own ``hashlib`` twin (``chunked_content_ids_host``,
which the JAX package holds bit-equal to the device function)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import chunked_values as jcv
from opendht_tpu.models import storage as jst
from opendht_tpu.models import swarm as jsw
from opendht_tpu_torch.convert import store_from_numpy
from opendht_tpu_torch.models import chunked_values as tcv
from opendht_tpu_torch.models import storage as tst
from opendht_tpu_torch.models import swarm as tsw

from torch_port_cases import (as_int64, assert_same, jax_origins, jax_swarm,
                              port_cfg, port_swarm, to_torch)

P, PARTS, W = 32, 3, 4
BASE = dict(slots=16, listen_slots=8, max_listeners=64, payload_words=W)
SCFG_U = jst.StoreConfig(**BASE)
SCFG_V = jst.StoreConfig(**BASE, verify=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def host_root(monkeypatch):
    """JAX's reads check the root through the JAX package's hashlib
    twin (see the module docstring)."""
    def root_ok(keys, payloads, lengths):
        want = jcv.chunked_content_ids_host(np.asarray(payloads),
                                            np.asarray(lengths))
        return jnp.asarray((want == np.asarray(keys)).all(axis=-1))
    monkeypatch.setattr(jcv, "_chunked_root_ok", root_ok)


@pytest.fixture(scope="module")
def world():
    sw, cfg = jax_swarm()
    return sw, cfg, port_swarm(sw), port_cfg(cfg)


def values(seed, p=P, parts=PARTS):
    """Payloads ``[p, parts, W]``, byte lengths covering zero, one word,
    exact part multiples, every part and past the end (clamped), and
    their hash-list keys (JAX's host twin)."""
    r = np.random.default_rng(seed)
    pl = r.integers(0, 2**32, (p, parts, W), dtype=np.uint64).astype(
        np.uint32)
    lens = r.integers(1, parts * W * 4 + 1, p).astype(np.uint32)
    lens[:6] = [0, 3, W * 4, 2 * W * 4, parts * W * 4, parts * W * 4 + 9]
    keys = jcv.chunked_content_ids_host(pl, lens)
    return pl, lens, keys


def assert_store_same(js, ts, what):
    for name in jst.SwarmStore._fields:
        a = as_int64(getattr(js, name)).reshape(-1)
        b = as_int64(getattr(ts, name)).reshape(-1)
        assert np.array_equal(a, b), f"{what}: store field {name} diverged"


class Plane:
    """A JAX store and the port's copy, driven by the chunked calls."""

    def __init__(self, world, scfg):
        self.sw, self.cfg, self.sw_t, self.cfg_t = world
        self.scfg, self.scfg_t = scfg, tst.StoreConfig(*scfg)
        self.j = jst.empty_store(self.cfg.n_nodes, scfg)
        self.t = store_from_numpy(*map(np.asarray, self.j), device="cpu")

    def og(self, seed, rows=P):
        return jax_origins(self.sw, jax.random.PRNGKey(seed), rows)

    def check(self, what):
        assert_store_same(self.j, self.t, what)

    def announce(self, keys, vals, seqs, now, seed, pl, lens, what):
        self.j, rj = jcv.announce_chunked(
            self.sw, self.cfg, self.j, self.scfg, jnp.asarray(keys),
            jnp.asarray(vals), jnp.asarray(seqs), now,
            jax.random.PRNGKey(seed), jnp.asarray(pl), jnp.asarray(lens))
        self.t, rt = tcv.announce_chunked(
            self.sw_t, self.cfg_t, self.t, self.scfg_t, to_torch(keys),
            to_torch(vals), to_torch(seqs), now, None, to_torch(pl),
            to_torch(lens), origins=self.og(seed), device="cpu")
        self.same_report(rj, rt, what)
        return rt

    def same_report(self, rj, rt, what):
        """Report, trace and store equal; on a batch without duplicate
        keys (every announce here) the trace conserves its requests."""
        assert_same(rj[:3], rt[:3], f"{what}: report")
        assert rj.trace.to_dict() == rt.trace.to_dict(), f"{what}: trace"
        tr = rt.trace.to_dict()
        assert what == "republish" or tr["requests"] == (
            tr["accepts_update"] + tr["accepts_new"] + tr["rejects"]
            + tr["integrity_rejects"]), what
        self.check(what)

    def get(self, keys, seed, what, scfg=None):
        scfg = scfg or self.scfg
        gj = jcv.get_chunked(self.sw, self.cfg, self.j, scfg,
                             jnp.asarray(keys), jax.random.PRNGKey(seed),
                             PARTS)
        gt = tcv.get_chunked(self.sw_t, self.cfg_t, self.t,
                             tst.StoreConfig(*scfg), to_torch(keys), None,
                             PARTS, origins=self.og(seed), device="cpu")
        assert_same(gj, gt, f"{what}: get result")
        return gt


def oracle(pl, lens):
    """The canonical words each value must read back as."""
    masked, _ = tcv.mask_chunk_payloads(to_torch(pl), to_torch(lens))
    return masked.reshape(len(lens), -1).numpy()


def test_ids_and_helpers():
    """Hash-list ids (JAX's device function op by op, both host twins),
    the canonical form, the root check, part keys and listener ids."""
    pl, lens, keys = values(1)
    with jax.disable_jit():
        want = np.asarray(jcv.chunked_content_ids(jnp.asarray(pl),
                                                  jnp.asarray(lens)))
    got = tcv.chunked_content_ids(to_torch(pl), to_torch(lens))
    assert_same([want], [got], "chunked ids")
    assert np.array_equal(want, keys)
    assert np.array_equal(tcv.chunked_content_ids_host(pl, lens), keys)
    assert np.array_equal(tcv.chunked_content_ids_host(to_torch(pl[0]),
                                                       to_torch(lens[:1])),
                          keys[:1])
    assert_same(jcv.mask_chunk_payloads(jnp.asarray(pl), jnp.asarray(lens)),
                tcv.mask_chunk_payloads(to_torch(pl), to_torch(lens)),
                "canonical form")
    bad = keys.copy()
    bad[::3, 2] ^= 1
    ok = tcv._chunked_root_ok(to_torch(bad), to_torch(pl), to_torch(lens))
    assert np.array_equal(ok.numpy(), np.arange(P) % 3 != 0)
    for j in range(PARTS):
        assert_same([jcv.part_key(jnp.asarray(keys), j)],
                    [tcv.part_key(to_torch(keys), j)], f"part key {j}")
    rid = np.array([0, 5, -1, 20, -7], np.int32)
    assert_same([jcv.chunked_reg_ids(jnp.asarray(rid), PARTS)],
                [tcv.chunked_reg_ids(to_torch(rid), PARTS)], "reg ids")
    args = (None, None, None, tst.StoreConfig(**BASE), to_torch(keys),
            to_torch(lens), to_torch(lens), 0, None)
    with pytest.raises(ValueError, match="words a part"):
        tcv.announce_chunked(*args, to_torch(pl[..., :2]), to_torch(lens))
    with pytest.raises(ValueError, match="part_range"):
        tcv.announce_chunked(*args, to_torch(pl), to_torch(lens),
                             part_range=(2, 2))


@pytest.mark.parametrize("scfg", [SCFG_U, SCFG_V], ids=["plain", "verify"])
def test_roundtrip_variable_lengths(scfg, world, host_root):
    pl, lens, keys = values(2)
    vals = np.arange(P, dtype=np.uint32) + 9
    s = Plane(world, scfg)
    rep = s.announce(keys, vals, np.full(P, 2, np.uint32), 0, 11, pl, lens,
                     "announce")
    assert rep.trace.to_dict()["integrity_rejects"] == 0
    g = s.get(keys, 12, "get")
    hit = g.hit.numpy()
    assert hit.mean() > 0.95 and hit[0] and g.length[0] == 0
    assert (g.length.numpy()[hit] == np.minimum(lens, PARTS * W * 4)[hit]
            ).all()
    assert (g.payload.numpy()[hit] == oracle(pl, lens)[hit]).all()
    # Too few parts for the longest values: they read as missing.
    gt = tcv.get_chunked(s.sw_t, s.cfg_t, s.t, s.scfg_t, to_torch(keys), None,
                         1, origins=s.og(12), device="cpu")
    short = (np.minimum(lens, PARTS * W * 4).astype(int) + 3) // 4 > W
    assert not gt.hit.numpy()[short].any()


def test_full_rings_read_missing(world, host_root):
    """A store too small for its values (2 slots a node): the rings evict
    the oldest parts, and both packages read the same values missing,
    never garbled.  On the card, 1,048,576 values of up to 4 parts on
    10M nodes overflow some 16-slot rings the same way, and the chunked
    checker's exact counts (``hit == values`` on the clean leg) then fail
    in both packages: JAX's checker and the port's give the clean leg's
    "not byte-exact" violation for these counts."""
    from opendht_tpu.tools import check_trace as jct
    from opendht_tpu_torch.tools import check_trace as tct
    scfg = jst.StoreConfig(**dict(BASE, slots=2))
    pl, lens, keys = values(2)
    s = Plane(world, scfg)
    s.announce(keys, np.arange(P, dtype=np.uint32) + 9,
               np.full(P, 2, np.uint32), 0, 11, pl, lens, "announce")
    g = s.get(keys, 12, "get")
    hit = g.hit.numpy()
    assert 0 < hit.sum() < P
    assert (g.payload.numpy()[hit] == oracle(pl, lens)[hit]).all()
    leg = {"hit": int(hit.sum()), "missing": int(P - hit.sum()),
           "garbled": 0, "exact": int(hit.sum()), "affected": 0,
           "trace": {f: 0 for f in ("requests", "accepts_update",
                                    "accepts_new", "rejects", "notified",
                                    "integrity_rejects")}}
    legs = {name: dict(leg) for name in ("clean", "torn_drop", "kill_mid",
                                         "torn_overwrite", "forge")}
    obj = {"kind": "swarm_chunked_trace", "bench": {}, "digest_parity": True,
           "params": {"values": P}, "conservation": {},
           "arms": {"defended": {"legs": legs}, "undefended": {"legs": legs}},
           "heal": {}}
    errs = jct.check_chunked_obj(obj)
    assert tct.check_chunked_obj(obj) == errs
    assert f"defended/clean: not byte-exact — hit {leg['hit']}, exact " \
        f"{leg['hit']}, garbled 0 over {P} values" in errs


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("leg", ["clean", "kill_mid", "torn_drop"])
def test_ring_oracle_predicts_reads(world, leg):
    """``chip_smoke.py``'s ring oracle (``ring_survivors`` and
    ``ring_readable``, from the replicas and the ring rule alone)
    predicts, row for row, which values the port's ``get_chunked``
    reads whole from a store too small for them (4 slots a node, ring
    refusals and overwrites both): the oracle that ties the card's
    full-ring waiver to a count."""
    cs = _chip_smoke()
    _, _, sw_t, cfg_t = world
    p, parts = 256, PARTS
    scfg = tst.StoreConfig(**dict(BASE, slots=4))
    pl, lens, keys = values(5, p=p)
    pl, lens, keys = to_torch(pl), to_torch(lens), to_torch(keys)
    words = (lens + 3) // 4
    n_parts = (-(-words // W)).clamp(1, parts)
    j = torch.arange(parts)
    sent = j[None, :] < n_parts[:, None]
    drop = torch.zeros((p, parts), dtype=torch.bool)
    drop[::3, 0] = True
    faults = {"clean": ({}, sent),
              "kill_mid": ({"part_range": (0, 1)}, sent & (j[None, :] < 1)),
              "torn_drop": ({"part_drop_mask": drop}, sent & ~drop)}
    kw, sent = faults[leg]

    def og(seed):
        return jax_origins(world[0], jax.random.PRNGKey(seed), p)
    store = tst.empty_store(cfg_t.n_nodes, scfg, torch.device("cpu"))
    store, rep = tcv.announce_chunked(
        sw_t, cfg_t, store, scfg, keys, torch.arange(p) + 1,
        torch.ones(p, dtype=torch.int64), 0, None, pl, lens, origins=og(31),
        device="cpu", **kw)
    got = tcv.get_chunked(sw_t, cfg_t, store, scfg, keys, None, parts,
                          origins=og(32), device="cpu")
    f_w, f_r = (tsw.lookup(sw_t, cfg_t, keys, origins=og(s),
                           device="cpu").found for s in (31, 32))
    surv = cs.ring_survivors(f_w, keys, sent, cfg_t.n_nodes, scfg.slots)
    pred = cs.ring_readable(surv, f_w, f_r, n_parts, sw_t.alive)
    assert int(surv.sum()) == int(store.used.sum())
    assert 0 < int(got.hit.sum()) < p
    assert torch.equal(got.hit, pred)


def test_churn_republish(world):
    pl, lens, keys = values(3)
    vals = np.arange(P, dtype=np.uint32) + 3
    s = Plane(world, SCFG_U)
    s.announce(keys, vals, np.ones(P, np.uint32), 0, 21, pl, lens, "put")
    churned = jsw.churn(s.sw, jax.random.PRNGKey(22), 0.4, s.cfg)
    s.sw, s.sw_t = churned, port_swarm(churned)
    node_idx = np.flatnonzero(np.asarray(churned.alive))[:128].astype(
        np.int32)
    st_j = {}
    s.j, rep_j = jst.republish_from(churned, s.cfg, s.j, SCFG_U,
                                    jnp.asarray(node_idx), 1,
                                    jax.random.PRNGKey(23), stats=st_j)
    s.t, rep_t = tst.republish_from(
        s.sw_t, s.cfg_t, s.t, s.scfg_t, to_torch(node_idx), 1,
        origins=s.og(23, st_j["lookup_rows"]), device="cpu")
    s.same_report(rep_j, rep_t, "republish")
    g = s.get(keys, 24, "get after republish")
    hit = g.hit.numpy()
    assert hit.mean() > 0.8
    assert (g.payload.numpy()[hit] == oracle(pl, lens)[hit]).all()


def _jax_faulty_announce(s, keys, vals, seqs, now, seed, pl, lens,
                         drop=None, part_range=None):
    """The JAX package's announce_chunked body with the port's fault
    knobs, from its own pieces (lookup, canonical form, part inserts)."""
    res = jsw.lookup(s.sw, s.cfg, jnp.asarray(keys), jax.random.PRNGKey(seed))
    pls, ln = jcv.mask_chunk_payloads(jnp.asarray(pl), jnp.asarray(lens))
    words = -(-ln.astype(jnp.int32) // 4)
    lo, hi = part_range or (0, PARTS)
    rep0, trace = jnp.zeros((P,), jnp.int32), None
    for j in range(lo, hi):
        active = (words > j * W) | (j == 0)
        if drop is not None:
            active = active & ~jnp.asarray(drop[:, j])
        found = jnp.where(active[:, None], res.found, -1)
        sizes = ln if j == 0 else jnp.ones_like(ln)
        s.j, rep, tr = jst._announce_insert(
            s.sw.alive, s.cfg, s.j, s.scfg._replace(verify=False), found,
            jcv.part_key(jnp.asarray(keys), j), jnp.asarray(vals),
            jnp.asarray(seqs), jnp.uint32(now), sizes, None, pls[:, j])
        trace = tr if trace is None else trace + tr
        rep0 = rep if j == 0 else rep0
    return jst.AnnounceReport(replicas=rep0, hops=res.hops, done=res.done,
                              trace=trace)


def test_torn_writes_read_missing(world):
    """A seq-2 overwrite killed after part 0 (``part_range``), the JAX
    test's plain part-0 announce, and values whose part 0 or part 1 was
    dropped (``part_drop_mask``): every torn multi-part value reads as
    missing, never garbled, and the rest read back whole."""
    pl, lens, keys = values(4)
    vals = np.arange(P, dtype=np.uint32) + 1
    ones = np.ones(P, np.uint32)
    n_parts = np.clip(-(-((np.minimum(lens, PARTS * W * 4).astype(int)
                           + 3) // 4) // W), 1, PARTS)
    s = Plane(world, SCFG_U)
    s.announce(keys, vals, ones, 0, 31, pl, lens, "put")
    # The JAX test's tear: a plain seq-2 announce of part 0 alone; the
    # port tears the same way with an overwrite killed after part 0.
    masked0 = np.asarray(jcv.mask_chunk_payloads(jnp.asarray(pl),
                                                 jnp.asarray(lens))[0])[:, 0]
    lens_c = np.minimum(lens, PARTS * W * 4).astype(np.uint32)
    s.j, rj = jst.announce(s.sw, s.cfg, s.j, SCFG_U, jnp.asarray(keys),
                           jnp.asarray(vals), jnp.asarray(ones + 1), 1,
                           jax.random.PRNGKey(32), sizes=jnp.asarray(lens_c),
                           payloads=jnp.asarray(masked0))
    s.t, rt = tcv.announce_chunked(
        s.sw_t, s.cfg_t, s.t, s.scfg_t, to_torch(keys), to_torch(vals),
        to_torch(ones + 1), 1, None, to_torch(pl), to_torch(lens),
        origins=s.og(32), part_range=(0, 1), device="cpu")
    s.same_report(rj, rt, "overwrite killed after part 0")
    g = s.get(keys, 33, "get after the torn overwrite")
    torn = n_parts > 1
    assert not g.hit.numpy()[torn].any() and g.hit.numpy()[~torn].mean() > .9
    # Dropped parts and a writer killed before its last part, on a
    # fresh store.
    drop = np.zeros((P, PARTS), bool)
    drop[::4, 0] = True
    drop[1::4, 1] = True
    for what, kw in (("dropped parts", dict(drop=drop)),
                     ("killed before the last part",
                      dict(part_range=(0, PARTS - 1)))):
        s.j = jst.empty_store(s.cfg.n_nodes, SCFG_U)
        s.t = store_from_numpy(*map(np.asarray, s.j), device="cpu")
        rj = _jax_faulty_announce(s, keys, vals, ones, 0, 34, pl, lens, **kw)
        s.t, rt = tcv.announce_chunked(
            s.sw_t, s.cfg_t, s.t, s.scfg_t, to_torch(keys), to_torch(vals),
            to_torch(ones), 0, None, to_torch(pl), to_torch(lens),
            origins=s.og(34), device="cpu",
            part_drop_mask=(None if "drop" not in kw
                            else torch.from_numpy(drop)),
            part_range=kw.get("part_range"))
        s.same_report(rj, rt, what)
        g = s.get(keys, 35, f"get after {what}")
        if "drop" in kw:
            torn = drop[:, 0] | (drop[:, 1] & (n_parts > 1))
        else:
            torn = n_parts == PARTS
        hit = g.hit.numpy()
        assert not hit[torn].any(), what
        assert (g.payload.numpy()[hit] == oracle(pl, lens)[hit]).all()


def test_forged_part_rejected(world, host_root):
    """Honest values, then every value re-announced at seq 2 with one
    word of part 1 flipped: the verified read rejects each value whose
    length reaches part 1 (missing, never garbled); the plain read
    serves the forged bytes.  Trace conservation holds on both puts."""
    pl, lens, keys = values(5)
    vals = np.arange(P, dtype=np.uint32) + 1
    forged = pl.copy()
    forged[:, 1, 0] ^= 0x80000000
    s = Plane(world, SCFG_V)
    s.announce(keys, vals, np.ones(P, np.uint32), 0, 41, pl, lens, "honest")
    s.announce(keys, vals, np.full(P, 2, np.uint32), 1, 42, forged, lens,
               "forged")
    reach = ((np.minimum(lens, PARTS * W * 4).astype(int) + 3) // 4) > W
    gv = s.get(keys, 43, "verified get")
    gu = s.get(keys, 43, "unverified get", scfg=SCFG_U)
    hv, hu = gv.hit.numpy(), gu.hit.numpy()
    assert not hv[reach].any()
    assert (gv.payload.numpy()[hv] == oracle(pl, lens)[hv]).all()
    assert hu[reach].mean() > 0.9
    assert (gu.payload.numpy()[hu & reach]
            != oracle(pl, lens)[hu & reach]).any(axis=1).all()


def test_listen_collect_ack_cancel(world, host_root):
    """listen → seq-2 announce (delivered) → collect (verified with the
    keys, and without) → ack → equal-seq re-announce (re-delivered) →
    cancel → collect."""
    pl, lens, keys = values(6)
    vals = np.arange(P, dtype=np.uint32) + 1
    regs = np.where(np.arange(P) < 12, np.arange(P), -1).astype(np.int32)
    regs[11] = 40                        # past max_listeners: dropped
    s = Plane(world, SCFG_V)
    s.announce(keys, vals, np.ones(P, np.uint32), 0, 51, pl, lens, "put")
    s.j, dj = jcv.listen_chunked(s.sw, s.cfg, s.j, SCFG_V, jnp.asarray(keys),
                                 jnp.asarray(regs), jax.random.PRNGKey(52),
                                 PARTS, now=1)
    s.t, dt = tcv.listen_chunked(s.sw_t, s.cfg_t, s.t, s.scfg_t,
                                 to_torch(keys), to_torch(regs), None, PARTS,
                                 now=1, origins=s.og(52), device="cpu")
    assert_same([dj], [dt], "listen done")
    s.check("listen")

    def collect(what, with_keys=True):
        k = jnp.asarray(keys) if with_keys else None
        with jax.disable_jit():
            cj = jcv.collect_chunked(s.j, SCFG_V, jnp.asarray(regs), PARTS,
                                     k)
        ct = tcv.collect_chunked(s.t, s.scfg_t, to_torch(regs), PARTS,
                                 to_torch(keys) if with_keys else None)
        assert_same(cj, ct, what)
        return ct

    v2 = vals + 100
    s.announce(keys, v2, np.full(P, 2, np.uint32), 2, 53, pl, lens, "seq 2")
    c = collect("collect")
    collect("collect without keys", with_keys=False)
    ready = c.ready.numpy()
    assert ready[:11].mean() > 0.8 and not ready[11:].any()
    assert (c.seq.numpy()[ready] == 2).all()
    assert (c.payload.numpy()[ready] == oracle(pl, lens)[ready]).all()
    for name, jfn, tfn in (
            ("ack", lambda st: jcv.ack_chunked(st, jnp.asarray(regs[:4]),
                                               PARTS),
             lambda st: tcv.ack_chunked(st, to_torch(regs[:4]), PARTS)),):
        s.j, s.t = jfn(s.j), tfn(s.t)
        s.check(name)
    assert not collect("collect after ack").ready.numpy()[:4].any()
    s.announce(keys, v2, np.full(P, 2, np.uint32), 3, 54, pl, lens,
               "equal-seq re-announce")
    assert collect("re-delivered").ready.numpy()[:4].any()
    s.j = jcv.cancel_chunked(s.j, SCFG_V, jnp.asarray(regs[:6]), PARTS)
    s.t = tcv.cancel_chunked(s.t, s.scfg_t, to_torch(regs[:6]), PARTS)
    s.check("cancel")
    assert not collect("collect after cancel").ready.numpy()[:6].any()


# ---------------------------------------------------------------------------
# the integrity plane on plain values
# ---------------------------------------------------------------------------

def honest_values(seed):
    from opendht_tpu.models.integrity import content_ids_host
    pl = np.random.default_rng(seed).integers(
        0, 2**32, (P, W), dtype=np.uint64).astype(np.uint32)
    return pl, content_ids_host(pl)


def forged_payloads(pl, seed):
    """JAX's ``forge_payloads`` at flip 1.0 and the port's from JAX's
    draws, equal."""
    from opendht_tpu.models.integrity import forge_payloads as jforge
    from opendht_tpu_torch.models.integrity import forge_payloads as tforge
    key = jax.random.PRNGKey(seed)
    fj, _ = jforge(jnp.asarray(pl), key, 1.0)
    k1, k2, k3 = jax.random.split(key, 3)
    ft, _ = tforge(to_torch(pl), to_torch(jax.random.uniform(k1, (P,)) < 1.0),
                   to_torch(jax.random.randint(k2, (P,), 0, W)),
                   to_torch(jax.random.randint(k3, (P,), 0, 32)))
    assert_same([fj], [ft], "forged payloads")
    return np.asarray(fj)


def plain_announce(s, scfg, keys, pl, seqs, now, seed, what):
    s.j, rj = jst.announce(s.sw, s.cfg, s.j, scfg, jnp.asarray(keys),
                           jnp.arange(1, P + 1, dtype=jnp.uint32),
                           jnp.asarray(seqs), now, jax.random.PRNGKey(seed),
                           payloads=jnp.asarray(pl))
    s.t, rt = tst.announce(s.sw_t, s.cfg_t, s.t, tst.StoreConfig(*scfg),
                           to_torch(keys), torch.arange(1, P + 1),
                           to_torch(seqs), now, payloads=to_torch(pl),
                           origins=s.og(seed), device="cpu")
    s.same_report(rj, rt, what)
    return rt.trace.to_dict()


def plain_get(s, scfg, keys, seed, what):
    gj = jst.get_values(s.sw, s.cfg, s.j, scfg, jnp.asarray(keys),
                        jax.random.PRNGKey(seed))
    gt = tst.get_values(s.sw_t, s.cfg_t, s.t, tst.StoreConfig(*scfg),
                        to_torch(keys), origins=s.og(seed), device="cpu")
    assert_same(gj, gt, what)
    return gt


def test_forged_payloads_rejected_with_exact_conservation(world):
    """Honest content-addressed values, then every payload forged under
    its honest key at a higher seq: the verified insert rejects every
    request (integrity_rejects == requests) and the honest bytes
    survive."""
    pl, keys = honest_values(7)
    s = Plane(world, SCFG_V)
    plain_announce(s, SCFG_V, keys, pl, np.ones(P, np.uint32), 0, 61,
                   "honest")
    forged = forged_payloads(pl, 62)
    tr = plain_announce(s, SCFG_V, keys, forged, np.full(P, 2, np.uint32), 1,
                        63, "forged")
    assert tr["integrity_rejects"] == tr["requests"] > 0
    assert tr["accepts_update"] == tr["accepts_new"] == 0
    g = plain_get(s, SCFG_V, keys, 64, "get after the attack")
    assert g.hit.all() and (g.payload.numpy() == pl).all()


def test_get_merge_discards_forged_replicas(world):
    """Forged payloads stored through an unverified insert: the plain
    read serves them, the verified read discards every one."""
    pl, keys = honest_values(8)
    s = Plane(world, SCFG_U)
    plain_announce(s, SCFG_U, keys, forged_payloads(pl, 65),
                   np.ones(P, np.uint32), 0, 66, "poison")
    assert plain_get(s, SCFG_U, keys, 67, "plain read").hit.all()
    assert not plain_get(s, SCFG_V, keys, 67, "verified read").hit.any()
