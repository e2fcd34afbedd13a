"""Device PHT secondary index over the swarm storage plane.

Counterpart of ``opendht_tpu/models/index.py``: the prefix-hash trie of
the reference's ``Pht`` (src/indexation/pht.cpp) — canary values marking
node presence, at most ``MAX_NODE_ENTRY_COUNT`` entries a leaf, a split
at the divergence point — stored in a
:class:`~opendht_tpu_torch.models.storage.SwarmStore` and driven as
batched device programs:

* **key encoding** — multi-field keys are padded, end-marked and z-curve
  interleaved like ``Pht.linearize`` (:func:`_linearize_batch`, a bit
  transpose), and a trie node at prefix depth ``m`` lives at
  ``SHA-1(content ‖ size byte)`` (:func:`_trie_node_hash`, the port's
  single-block SHA-1), so both packages address the same 160-bit keys;
* **value taxonomy** — one value a (node, key) slot: discriminator 0 (the
  bare node key) holds the canary, 1..16 the leaf's entry slots
  (:func:`slot_keys`), so a node cannot hold a 17th entry and must split;
* **batched leaf search** — :meth:`DeviceIndex.leaf_search` walks ``B``
  keys in lock step, one canary get batch a refinement round, in at most
  ``IndexSpec.probe_round_bound`` rounds;
* **insert** — :meth:`DeviceIndex.insert_batch` walks keys to their
  leaves, fills free slots in arrival order, and splits full leaves with
  the host's rule, re-inserting the old leaf's entries first;
* **range scan** — :meth:`DeviceIndex.range_query` walks the contiguous
  leaf span of ``[lo, hi]`` and returns the exact entry set.

Every get and announce goes through the port's
:func:`~opendht_tpu_torch.models.storage.get_values` /
:func:`~opendht_tpu_torch.models.storage.announce`, whose lookups run K1
or K2 by ``cfg.merge_impl`` on the card.  Each probe batch is read back
once (the walk's next round depends on it).  The host bookkeeping (the
trie walk, the split rule, :class:`PhtOracle`) is numpy, as in JAX.

Randomness: the JAX engine folds a key a store op for the lookup
origins; here op ``i`` (1, 2, ...) of a ``P``-row batch takes its
origins from ``draws(i, P)`` if given, else from a ``torch.Generator``
seeded ``seed``.

:class:`StoreDht` is the host DHT surface (get / put / listen) the host
:class:`~opendht_tpu_torch.indexation.pht.Pht` runs against, over the
same store and slot-key encoding, so a host-built and a device-built
index are views of one stored trie.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, FrozenSet, List, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.sha1 import sha1_one_block, sha1_pad_le55
from ..ops.u32 import MASK32
from .storage import StoreConfig, SwarmStore, announce, get_values, pow2_width
from .swarm import Swarm, SwarmConfig, _require_on, _sample_origins, resolve_device

# From opendht_tpu/indexation/pht.py: the value-type namespace of index
# values and the reference's leaf capacity (src/indexation/pht.cpp).
INDEX_PREFIX = "index.pht."
MAX_NODE_ENTRY_COUNT = 16

# Canary value token ("CANA"); entries carry per-entry tokens
# (:func:`entry_tokens`), and the two cannot collide: canaries live only
# at discriminator-0 keys, entries only at 1..16.
CANARY_TOKEN = 0x43414E41
# Odd, so invertible mod 2**32: distinct discriminators give distinct keys.
SLOT_KEY_MULT = 0x9E3779B9
_TOKEN_MULT = 0x85EBCA6B


class IndexSpec(NamedTuple):
    """Static index geometry: ``fields`` are sorted ``(name,
    max_bytes)`` pairs.  Every field pads to ``max(max_bytes) + 1``
    bytes (the +1 hosts the end-marker bit) and the z-curve interleaves
    all fields bit by bit, so a full key is ``prefix_bits`` long."""
    fields: Tuple[Tuple[str, int], ...]
    name: str = "index"

    @classmethod
    def from_key_spec(cls, name: str, key_spec: Dict[str, int]
                      ) -> "IndexSpec":
        spec = cls(tuple(sorted((k, int(v)) for k, v in
                               key_spec.items())), name)
        if spec.prefix_bytes > 32:
            raise ValueError(
                f"IndexSpec too wide: {spec.prefix_bytes} linearized "
                f"bytes > 32 (the trie hash packs prefix + size byte "
                f"into one SHA-1 block)")
        return spec

    @property
    def field_len(self) -> int:
        return max(b for _, b in self.fields) + 1

    @property
    def n_fields(self) -> int:
        return len(self.fields)

    @property
    def prefix_bytes(self) -> int:
        return self.n_fields * self.field_len

    @property
    def prefix_bits(self) -> int:
        return self.prefix_bytes * 8

    @property
    def prefix_words(self) -> int:
        return -(-self.prefix_bytes // 4)

    @property
    def payload_words(self) -> int:
        """Entry payload: hash limbs [0:5], value id [5], prefix size in
        bits [6], the full prefix words [7:7+prefix_words]."""
        return 7 + self.prefix_words

    @property
    def value_type(self) -> str:
        return INDEX_PREFIX + self.name

    @property
    def canary_type(self) -> str:
        return self.value_type + ".canary"

    @property
    def probe_round_bound(self) -> int:
        """Leaf-walk round bound: two full halvings of ``[0,
        prefix_bits)`` (a depth-hint miss restarts the search once) plus
        the empty-trie resolution round."""
        return 2 * (int(math.ceil(math.log2(self.prefix_bits + 1))) + 1)


# ---------------------------------------------------------------------------
# key encoding on the device (u32 words held in int64)
# ---------------------------------------------------------------------------

def _linearize_batch(spec: IndexSpec, fbytes: torch.Tensor,
                     flens: torch.Tensor) -> torch.Tensor:
    """Vectorized ``Pht.linearize``: ``fbytes [B, F, field_len]`` raw
    field bytes (zero-padded), ``flens [B, F]`` their lengths → ``[B,
    PW]`` MSB-first prefix words.  The z-curve is a bit transpose: bit
    ``t`` of the output is bit ``t // F`` of field ``t % F``."""
    fl = spec.field_len
    dev = fbytes.device
    idx = torch.arange(fl, device=dev)
    marked = fbytes | torch.where(idx[None, None, :] == flens[..., None],
                                  0x80, 0)
    bidx = torch.arange(fl * 8, device=dev)
    fbits = (marked[..., bidx // 8] >> (7 - bidx % 8)) & 1   # [B,F,fl*8]
    z = fbits.transpose(-1, -2).reshape(fbits.shape[0], -1)
    pw = spec.prefix_words
    pad = pw * 32 - spec.prefix_bits
    if pad:
        z = torch.cat([z, z.new_zeros((z.shape[0], pad))], dim=1)
    weights = 1 << (31 - torch.arange(32, device=dev))
    return (z.reshape(-1, pw, 32) * weights).sum(-1)


def _word_masks(pw: int, nbits: torch.Tensor) -> torch.Tensor:
    """``[..., pw]`` masks keeping the first ``nbits`` bits."""
    limbs = []
    for w in range(pw):
        rem = (nbits - 32 * w).clamp(0, 32)
        m = (MASK32 << (32 - rem).clamp(0, 31)) & MASK32
        limbs.append(torch.where(rem == 0, 0, m))
    return torch.stack(limbs, dim=-1)


def _trie_node_hash(spec: IndexSpec, bits: torch.Tensor,
                    depth: torch.Tensor) -> torch.Tensor:
    """Batched ``Prefix.hash``: SHA-1(masked content ‖ size byte) of
    ``bits [..., PW]`` at ``depth [...]`` bits → ``[..., 5]`` key
    limbs."""
    pw = spec.prefix_words
    d = depth.to(torch.int64)
    masked = bits & _word_masks(pw, d)
    nb = (d + 7) // 8                        # content bytes
    content = torch.cat([masked, masked.new_zeros(masked.shape[:-1] + (1,))],
                        dim=-1)
    lane = (nb - 4 * (nb // 4)).clamp(0, 3)
    or_val = (d & 0xFF) << (8 * (3 - lane))
    sel = torch.arange(pw + 1, device=bits.device)
    content = content | torch.where(sel == (nb // 4)[..., None],
                                    or_val[..., None], 0)
    return sha1_one_block(sha1_pad_le55(content, nb + 1))


def slot_keys(tkeys: np.ndarray, d) -> np.ndarray:
    """Store key of discriminator ``d`` under trie-node key ``tkeys
    [..., 5]`` (numpy): 0 is the canary (the node key itself), 1..16 the
    entry slots."""
    tkeys = np.asarray(tkeys, np.uint32)
    mix = (np.asarray(d).astype(np.uint64) * SLOT_KEY_MULT
           % (1 << 32)).astype(np.uint32)
    shape = np.broadcast_shapes(tkeys.shape[:-1], mix.shape)
    out = np.broadcast_to(tkeys, shape + (5,)).copy()
    out[..., 4] ^= np.broadcast_to(mix, shape)
    return out


def entry_tokens(ehash0, vid) -> np.ndarray:
    """Per-entry u32 value token: limb 0 of the entry's hash mixed with
    its value id (the identity the same-value refresh test keys on)."""
    return (np.asarray(ehash0, np.uint64)
            ^ (np.asarray(vid, np.uint64) * _TOKEN_MULT)
            ).astype(np.uint64).astype(np.uint32) & np.uint32(0xFFFFFFFF)


def _pack_entry_payloads(spec: IndexSpec, ehash: torch.Tensor,
                         vid: torch.Tensor, bits: torch.Tensor
                         ) -> torch.Tensor:
    """Entry payloads ``[B, payload_words]`` (layout:
    :attr:`IndexSpec.payload_words`)."""
    b = ehash.shape[0]
    return torch.cat([ehash, vid[:, None],
                      torch.full((b, 1), spec.prefix_bits, dtype=ehash.dtype,
                                 device=ehash.device), bits], dim=1)


# ---------------------------------------------------------------------------
# host-side bit helpers (numpy)
# ---------------------------------------------------------------------------

def np_mask_bits(bits: np.ndarray, depth) -> np.ndarray:
    """Numpy twin of the per-word prefix mask."""
    bits = np.asarray(bits, np.uint32)
    depth = np.asarray(depth, np.int64)
    pw = bits.shape[-1]
    out = bits.copy()
    for w in range(pw):
        rem = np.clip(depth - 32 * w, 0, 32)
        mask = np.where(
            rem == 0, 0,
            (0xFFFFFFFF << (32 - np.minimum(rem, 32))) & 0xFFFFFFFF
        ).astype(np.uint32)
        out[..., w] &= mask
    return out


def np_get_bit(bits: np.ndarray, pos) -> np.ndarray:
    pos = np.asarray(pos, np.int64)
    w = pos // 32
    return (np.take_along_axis(
        np.asarray(bits, np.uint32), w[..., None], axis=-1)[..., 0]
        >> (31 - pos % 32).astype(np.uint32)) & 1


def np_flip_bit(bits: np.ndarray, pos) -> np.ndarray:
    """Rows with bit ``pos`` flipped (sibling derivation)."""
    bits = np.asarray(bits, np.uint32).copy()
    pos = np.asarray(pos, np.int64)
    w = pos // 32
    m = (np.uint32(1) << (31 - pos % 32).astype(np.uint32))
    np.put_along_axis(
        bits, w[..., None],
        np.take_along_axis(bits, w[..., None], axis=-1) ^ m[..., None],
        axis=-1)
    return bits


def np_bits_key(bits: np.ndarray, depth: int) -> bytes:
    """Canonical hashable id of a trie node: its masked prefix bytes."""
    return bytes(np_mask_bits(bits, depth).astype(">u4").tobytes())


def fields_to_arrays(spec: IndexSpec, keys: List[Dict[str, bytes]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Key dicts → the ``(fbytes, flens)`` arrays
    :func:`_linearize_batch` takes.  Validates like ``Pht.valid_key``."""
    fl = spec.field_len
    b = len(keys)
    fbytes = np.zeros((b, spec.n_fields, fl), np.uint32)
    flens = np.zeros((b, spec.n_fields), np.int32)
    names = [n for n, _ in spec.fields]
    caps = {n: c for n, c in spec.fields}
    for i, k in enumerate(keys):
        if set(k) != set(names):
            raise ValueError("key does not match the index key spec")
        for f, n in enumerate(names):
            data = k[n]
            if len(data) > caps[n]:
                raise ValueError(f"field {n!r} longer than spec")
            fbytes[i, f, :len(data)] = np.frombuffer(data, np.uint8)
            flens[i, f] = len(data)
    return fbytes, flens


def _pow2_width(m: int, floor: int = 16) -> int:
    """Batches pad to a power of two ≥ ``floor`` (the storage plane's
    rule)."""
    return pow2_width(m, floor)


def _np_increment(words: np.ndarray, nbits: int):
    """Big-integer successor of an ``nbits``-wide MSB-aligned word
    vector (+1 at bit ``nbits - 1``) → ``(succ, carry)``."""
    out = words.astype(np.uint64).copy()
    pos = nbits - 1
    w = pos // 32
    inc = np.uint64(1) << np.uint64(31 - pos % 32)
    while w >= 0:
        out[w] += inc
        if out[w] <= 0xFFFFFFFF:
            return out.astype(np.uint32), False
        out[w] &= 0xFFFFFFFF
        inc = np.uint64(1)
        w -= 1
    return out.astype(np.uint32), True


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class DeviceIndex:
    """Batched PHT engine over a device :class:`SwarmStore`.

    Holds the live store (updated in place by every put), the host trie
    bookkeeping (the deepest canary written, ``_max_depth``; the op
    count ``_op``) and walk statistics (``stats``).  The linearizer, the
    SHA-1 node keys, the canary probes and the entry gets and puts run
    on ``device`` (the card unless ``"cpu"`` is asked for) through the
    storage plane's entry points.  ``draws(op, rows)`` (optional)
    returns the origins of store op ``op``; otherwise a generator
    seeded ``seed`` draws them."""

    def __init__(self, swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                 scfg: StoreConfig, spec: IndexSpec, seed: int = 0, *,
                 draws: Callable[[int, int], torch.Tensor] | None = None,
                 device=None):
        if scfg.payload_words != spec.payload_words:
            raise ValueError(
                f"index store needs payload_words == "
                f"{spec.payload_words} (entry wire format), got "
                f"{scfg.payload_words}")
        if scfg.slots < MAX_NODE_ENTRY_COUNT + 1:
            # A trie node's canary and 16 entries share a key prefix,
            # so they land on one quorum: a smaller ring would evict
            # the canary mid-insert.
            raise ValueError(
                f"index store needs slots ≥ {MAX_NODE_ENTRY_COUNT + 1} "
                f"(one full trie node — canary + "
                f"{MAX_NODE_ENTRY_COUNT} entries — lands on one "
                f"node's ring), got {scfg.slots}")
        self.device = resolve_device(device)
        _require_on(swarm, self.device)
        self.swarm, self.cfg = swarm, cfg
        self.store, self.scfg = store, scfg
        self.spec = spec
        self._draws = draws
        self._gen = (torch.Generator(device=self.device).manual_seed(seed)
                     if draws is None else None)
        self._op = 0
        self._max_depth = 0          # deepest canary ever written
        self.stats = {
            "probe_batches": 0, "probe_keys": 0, "walk_rounds_max": 0,
            "splits": 0, "split_levels": 0, "entries_inserted": 0,
            "dup_refreshed": 0, "overfull_drops": 0, "canary_puts": 0,
            "entry_puts": 0, "insert_passes": 0,
        }

    # -- engine ops (the two hooks a sharded engine overrides) ---------

    def _next_origins(self, rows: int) -> torch.Tensor:
        self._op += 1
        if self._draws is None:
            return _sample_origins(self._gen, self.swarm.alive, rows)
        return self._draws(self._op, rows)

    def _get_raw(self, keys: torch.Tensor):
        res = get_values(self.swarm, self.cfg, self.store, self.scfg, keys,
                         origins=self._next_origins(keys.shape[0]),
                         device=self.device)
        return res.hit, res.val, res.payload

    def _put_raw(self, keys, vals, seqs, payloads) -> None:
        self.store, _rep = announce(
            self.swarm, self.cfg, self.store, self.scfg, keys, vals, seqs,
            0, payloads=payloads, origins=self._next_origins(keys.shape[0]),
            device=self.device)

    # -- padded batch wrappers ----------------------------------------

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).astype(np.int64))).to(self.device)

    def _get(self, keys_np: np.ndarray):
        """Batched store get of ``[M, 5]`` keys → host ``(hit, val,
        payload)``, read back in one transfer.  Pads to a power-of-two
        width by repeating row 0 (duplicate gets are idempotent)."""
        m = keys_np.shape[0]
        w = _pow2_width(m)
        if w > m:
            keys_np = np.concatenate(
                [keys_np, np.broadcast_to(keys_np[:1], (w - m, 5))])
        hit, val, pl = self._get_raw(self._upload(keys_np))
        host = torch.cat([hit[:m, None].to(torch.int64), val[:m, None],
                          pl[:m]], dim=1).cpu().numpy()
        self.stats["probe_batches"] += 1
        self.stats["probe_keys"] += int(m)
        return (host[:, 0].astype(bool), host[:, 1].astype(np.uint32),
                host[:, 2:].astype(np.uint32))

    def _put(self, keys_np, vals_np, payloads_np) -> None:
        """Batched announce at seq 1 (index values are immutable; a
        re-put is a same-value refresh).  Pads by repeating row 0."""
        m = keys_np.shape[0]
        if m == 0:
            return
        w = _pow2_width(m)
        if w > m:
            keys_np = np.concatenate(
                [keys_np, np.broadcast_to(keys_np[:1], (w - m, 5))])
            vals_np = np.concatenate(
                [vals_np, np.broadcast_to(vals_np[:1], (w - m,))])
            payloads_np = np.concatenate(
                [payloads_np,
                 np.broadcast_to(payloads_np[:1],
                                 (w - m, payloads_np.shape[1]))])
        self._put_raw(self._upload(keys_np), self._upload(vals_np),
                      torch.ones((w,), dtype=torch.int64,
                                 device=self.device),
                      self._upload(payloads_np))

    # -- key encoding --------------------------------------------------

    def linearize(self, keys: List[Dict[str, bytes]]) -> np.ndarray:
        """Key dicts → ``[B, PW]`` linearized prefix words (uint32)."""
        fbytes, flens = fields_to_arrays(self.spec, keys)
        out = _linearize_batch(self.spec, self._upload(fbytes),
                               self._upload(flens))
        return out.cpu().numpy().astype(np.uint32)

    def _node_hash(self, bits_np: np.ndarray,
                   depth_np: np.ndarray) -> np.ndarray:
        out = _trie_node_hash(self.spec, self._upload(bits_np),
                              self._upload(depth_np))
        return out.cpu().numpy().astype(np.uint32)

    # -- batched binary search on prefix length ------------------------

    def leaf_search(self, bits_np: np.ndarray) -> np.ndarray:
        """Walk ``[B]`` keys to their leaf depths: each round is one
        canary get batch (two probes an active key).  The interval
        starts at ``[0, _max_depth]`` (the host's cache hint); a probe
        proving the leaf lies below the hint restarts that row once
        over the full interval.  Returns the leaf depths ``[B]``."""
        s = self.spec.prefix_bits
        b = bits_np.shape[0]
        lo = np.zeros(b, np.int64)
        hi = np.full(b, min(s - 1, self._max_depth), np.int64)
        done = np.zeros(b, bool)
        leaf = np.zeros(b, np.int64)
        rounds = 0
        while not done.all() and rounds <= self.spec.probe_round_bound:
            act = np.nonzero(~done)[0]
            amid = (lo[act] + hi[act]) // 2
            amid2 = np.minimum(amid + 1, s - 1)
            # Both probes' node keys in one hash batch (rows then rows + 1).
            # graftlint: disable=sync-in-loop (the PHT leaf search decides each key's next probe depth on the host: one hash readback a search round, bounded by probe_round_bound)
            keys = self._node_hash(np.concatenate([bits_np[act]] * 2),
                                   np.concatenate([amid, amid2]))
            # graftlint: disable=sync-in-loop (the canary get of the same search round, read back once a round; its hits steer the host binary search)
            hit, val, _ = self._get(keys.astype(np.uint32))
            is_pht = hit & (val == CANARY_TOKEN)
            first = is_pht[:act.size]
            second = is_pht[act.size:] & (amid < s - 1)
            go_up = ~first
            go_dn = first & second
            at_leaf = first & ~second
            # canary(mid) ∧ ¬canary(mid+1) ⇒ mid is the leaf.
            leaf[act[at_leaf]] = amid[at_leaf]
            done[act[at_leaf]] = True
            # ¬canary(mid) ⇒ leaf < mid; an empty interval here means
            # no canary at depth 0: the empty trie's root leaf.
            hi[act[go_up]] = amid[go_up] - 1
            fin_up = go_up & (amid - 1 < lo[act])
            leaf[act[fin_up]] = 0
            done[act[fin_up]] = True
            # canary(mid+1) ⇒ leaf > mid; an empty interval here means
            # the hint was too low — restart over [mid+1, s-1].
            lo[act[go_dn]] = amid[go_dn] + 1
            retry = go_dn & (amid + 1 > hi[act])
            hi[act[retry]] = s - 1
            rounds += 1
        self.stats["walk_rounds_max"] = max(
            self.stats["walk_rounds_max"], rounds)
        if not done.all():
            raise RuntimeError(
                "leaf walk exceeded the binary-search round bound — "
                "the canary structure is inconsistent")
        return leaf

    def read_node_entries(self, bits_np: np.ndarray,
                          depth_np: np.ndarray):
        """Entry sets of ``[A]`` trie nodes: one get batch over the 16
        slot keys of each → ``(tkeys [A,5], valid [A,16], ehash
        [A,16,5], evid [A,16], ebits [A,16,PW])``."""
        a = bits_np.shape[0]
        pw = self.spec.prefix_words
        tkeys = self._node_hash(bits_np, depth_np)
        d = np.arange(1, MAX_NODE_ENTRY_COUNT + 1, dtype=np.uint32)
        skeys = slot_keys(tkeys[:, None, :], d[None, :])   # [A,16,5]
        hit, _val, pl = self._get(skeys.reshape(-1, 5))
        valid = hit.reshape(a, MAX_NODE_ENTRY_COUNT)
        pl = pl.reshape(a, MAX_NODE_ENTRY_COUNT, -1)
        return (tkeys, valid, pl[:, :, 0:5], pl[:, :, 5],
                pl[:, :, 7:7 + pw])

    # -- insert ---------------------------------------------------------

    def insert_batch(self, keys: List[Dict[str, bytes]],
                     ehash: np.ndarray, evid: np.ndarray) -> dict:
        """Insert ``B`` (key → (hash, vid)) entries, sequentially
        equivalent to one-at-a-time inserts: a pass ranks the rows
        reaching one leaf in worklist order (free slots go to the
        earliest), only the earliest row at a full leaf splits it (later
        rows requeue), and a split requeues the old leaf's entries
        before the splitting row.  Passes repeat until the worklist
        drains.  Returns a copy of ``stats``."""
        bits = self.linearize(keys)
        ehash = np.asarray(ehash, np.uint32).reshape(-1, 5)
        evid = np.asarray(evid, np.uint32).reshape(-1)
        s = self.spec.prefix_bits

        # Growable work store (migrated entries append).
        all_bits = list(bits)
        all_ehash = list(ehash)
        all_evid = list(evid)
        work = list(range(len(all_bits)))
        passes = 0
        max_passes = s + 4
        while work and passes < max_passes:
            passes += 1
            abits = np.stack([all_bits[i] for i in work])
            aehash = np.stack([all_ehash[i] for i in work])
            aevid = np.asarray([all_evid[i] for i in work], np.uint32)
            depth = self.leaf_search(abits)
            # graftlint: disable=sync-in-loop (insert pass: the leaf entries are read back once a pass to decide splits on the host)
            tkeys, valid, n_eh, n_ev, n_eb = self.read_node_entries(
                abits, depth)

            gks: List[bytes] = []
            groups: Dict[bytes, List[int]] = {}
            for j in range(len(work)):
                gk = np_bits_key(abits[j], int(depth[j])) \
                    + int(depth[j]).to_bytes(2, "big")
                gks.append(gk)
                groups.setdefault(gk, []).append(j)

            next_work: List[int] = []
            canary_jobs: List[Tuple[np.ndarray, int]] = []
            put_keys: List[np.ndarray] = []
            put_vals: List[int] = []
            put_ehash: List[np.ndarray] = []
            put_evid: List[int] = []
            put_bits: List[np.ndarray] = []
            split_leaves: set = set()
            # (ehash, vid) pairs an earlier row of this pass is already
            # putting at each leaf (the store cannot show them yet).
            pass_pairs: Dict[bytes, set] = {}

            for j in range(len(work)):
                gk = gks[j]
                rank = groups[gk].index(j)
                d_j = int(depth[j])
                # Same hash + vid already at the leaf (or put there this
                # pass): a same-value refresh, the set is unchanged.
                pair = (aehash[j].tobytes(), int(aevid[j]))
                dup = (valid[j] & (n_ev[j] == aevid[j])
                       & (n_eh[j] == aehash[j][None, :]).all(axis=1))
                if dup.any() or pair in pass_pairs.get(gk, ()):
                    self.stats["dup_refreshed"] += 1
                    continue
                free = np.nonzero(~valid[j])[0]
                occ = MAX_NODE_ENTRY_COUNT - free.size
                if rank < free.size:
                    slot_d = int(free[rank]) + 1
                    pass_pairs.setdefault(gk, set()).add(pair)
                    put_keys.append(slot_keys(tkeys[j], slot_d))
                    put_vals.append(int(entry_tokens(
                        aehash[j][0], aevid[j])))
                    put_ehash.append(aehash[j])
                    put_evid.append(int(aevid[j]))
                    put_bits.append(abits[j])
                    # Canary refresh at the node (and its sibling below
                    # the root): the deterministic part of updateCanary.
                    canary_jobs.append((abits[j], d_j))
                    if d_j > 0:
                        canary_jobs.append(
                            (np_flip_bit(abits[j], d_j - 1), d_j))
                    self.stats["entries_inserted"] += 1
                    continue
                if occ < MAX_NODE_ENTRY_COUNT:
                    # Free slots taken by earlier rows of this pass:
                    # requeue (the next pass sees the true occupancy).
                    next_work.append(work[j])
                    continue
                # Full leaf: the earliest row splits, the rest requeue.
                if gk in split_leaves:
                    next_work.append(work[j])
                    continue
                split_leaves.add(gk)
                # Divergence point of the leaf's entries and this key
                # (Pht._found_split_location).
                loc = s - 1
                for i in range(s - 1):
                    eb = np_get_bit(n_eb[j], np.full(
                        MAX_NODE_ENTRY_COUNT, i))
                    kb = int(np_get_bit(abits[j][None, :],
                                        np.asarray([i]))[0])
                    if (eb[valid[j]] != kb).any():
                        loc = i + 1
                        break
                if loc <= d_j:
                    # No divergence below the leaf (> 16 identical
                    # keys): unsplittable — count and drop.
                    self.stats["overfull_drops"] += 1
                    continue
                # Canary chain old leaf → divergence point, siblings
                # included per level (Pht._split + updateCanary).
                for i in range(max(d_j, 1), loc + 1):
                    canary_jobs.append((abits[j], i))
                    canary_jobs.append((np_flip_bit(abits[j], i - 1), i))
                self.stats["splits"] += 1
                self.stats["split_levels"] += loc - d_j
                self._max_depth = max(self._max_depth, loc)
                # Requeue the old leaf's entries first (listener-order
                # migration), then the splitting row.
                for sl in np.nonzero(valid[j])[0]:
                    all_bits.append(n_eb[j][sl].astype(np.uint32))
                    all_ehash.append(n_eh[j][sl].astype(np.uint32))
                    all_evid.append(np.uint32(n_ev[j][sl]))
                    next_work.append(len(all_bits) - 1)
                next_work.append(work[j])

            # One canary batch, then one entry batch, a pass (the host
            # writes the chain before the value put).
            if canary_jobs:
                cb = np.stack([b for b, _ in canary_jobs])
                cd = np.asarray([d for _, d in canary_jobs], np.int32)
                # graftlint: disable=sync-in-loop (insert pass: one hash readback of the canary keys a pass (the host writes the chain before the value put))
                ckeys = self._node_hash(cb, cd)
                # graftlint: disable=sync-in-loop (insert pass: the canary put draws its origins with one alive-count readback a pass)
                self._put(ckeys, np.full(len(canary_jobs), CANARY_TOKEN,
                                         np.uint32),
                          np.zeros((len(canary_jobs),
                                    self.spec.payload_words), np.uint32))
                self.stats["canary_puts"] += len(canary_jobs)
            if put_keys:
                pl = _pack_entry_payloads(
                    self.spec, self._upload(np.stack(put_ehash)),
                    self._upload(np.asarray(put_evid, np.uint32)),
                    self._upload(np.stack(put_bits)))
                # graftlint: disable=sync-in-loop (insert pass: the entry put draws its origins with one alive-count readback a pass)
                self._put(np.stack(put_keys).astype(np.uint32),
                          np.asarray(put_vals, np.uint32),
                          # graftlint: disable=sync-in-loop (insert pass: the packed payloads go to the host store batch once a pass)
                          pl.cpu().numpy())
                self.stats["entry_puts"] += len(put_keys)
            work = next_work
        self.stats["insert_passes"] += passes
        if work:
            self.stats["overfull_drops"] += len(work)
        return dict(self.stats)

    # -- reads ----------------------------------------------------------

    def lookup_batch(self, keys: List[Dict[str, bytes]]):
        """Exact lookup of ``B`` keys: walk to the leaves, probe their
        slots, keep the entries whose full prefix equals the key.
        Returns ``(leaf_depths [B], [[(ehash_bytes, vid), ...], ...])``."""
        bits = self.linearize(keys)
        depth = self.leaf_search(bits)
        _tk, valid, eh, ev, eb = self.read_node_entries(bits, depth)
        out = []
        for j in range(bits.shape[0]):
            match = valid[j] & (eb[j] == bits[j][None, :]).all(axis=1)
            out.append([
                (eh[j][sl].astype(">u4").tobytes(), int(ev[j][sl]))
                for sl in np.nonzero(match)[0]])
        return depth, out

    def range_query(self, lo_bits: np.ndarray, hi_bits: np.ndarray,
                    max_leaves: int = 65536):
        """Exact range scan of ``R`` inclusive ranges of linearized key
        space: walk each range's contiguous leaf span (z-curve order is
        prefix order) and return the entries inside.  Returns
        ``(R lists of (ehash_bytes, vid), leaves_touched [R])``."""
        pw = self.spec.prefix_words
        lo_bits = np.asarray(lo_bits, np.uint32).reshape(-1, pw)
        hi_bits = np.asarray(hi_bits, np.uint32).reshape(-1, pw)
        r = lo_bits.shape[0]
        cur = lo_bits.copy()
        active = np.ones(r, bool)
        results: List[list] = [[] for _ in range(r)]
        seen: List[set] = [set() for _ in range(r)]
        leaves = np.zeros(r, np.int64)
        steps = 0
        while active.any():
            steps += 1
            if steps > max_leaves:
                raise RuntimeError("range walk exceeded max_leaves")
            act = np.nonzero(active)[0]
            depth = self.leaf_search(cur[act])
            # graftlint: disable=sync-in-loop (range walk: the visited leaves' entries are read back once a step and filtered on the host)
            _tk, valid, eh, ev, eb = self.read_node_entries(
                cur[act], depth)
            leaves[act] += 1
            for k, q in enumerate(act):
                lo_t = tuple(lo_bits[q].tolist())
                hi_t = tuple(hi_bits[q].tolist())
                for sl in np.nonzero(valid[k])[0]:
                    # graftlint: disable=sync-in-loop (eb is read_node_entries' numpy copy: .tolist() reads no tensor)
                    full = tuple(eb[k][sl].tolist())
                    if lo_t <= full <= hi_t:
                        ent = (eh[k][sl].astype(">u4").tobytes(),
                               int(ev[k][sl]))
                        if ent not in seen[q]:
                            seen[q].add(ent)
                            results[q].append(ent)
                # Step past this leaf's key space: its upper bound is
                # the masked prefix with every lower bit set, clamped to
                # the key width (pad bits past prefix_bits stay zero).
                d = int(depth[k])
                upper = np_mask_bits(cur[q], d) | (
                    ~np_mask_bits(np.full_like(cur[q], 0xFFFFFFFF), d)
                    & np.uint32(0xFFFFFFFF))
                upper = np_mask_bits(upper, self.spec.prefix_bits)
                nxt, carry = _np_increment(upper, self.spec.prefix_bits)
                # graftlint: disable=sync-in-loop (nxt is _np_increment's numpy array: .tolist() reads no tensor)
                if carry or tuple(nxt.tolist()) > tuple(
                        hi_bits[q].tolist()):
                    active[q] = False
                else:
                    cur[q] = nxt
        return results, leaves

    # -- trie enumeration ------------------------------------------------

    def trie_snapshot(self):
        """Breadth-first walk of the canary structure from the root →
        ``(leaves, interior)``: ``leaves`` maps ``(depth,
        prefix_bytes)`` to the frozenset of ``(ehash_bytes, vid)`` held
        there, ``interior`` is the set of marked non-leaf nodes — the
        trie as read from the store."""
        zero = np.zeros(self.spec.prefix_words, np.uint32)
        hit, val, _ = self._get(self._node_hash(
            zero[None, :], np.asarray([0], np.int32)))
        leaves: Dict[Tuple[int, bytes], FrozenSet] = {}
        interior = set()
        if not (hit[0] and val[0] == CANARY_TOKEN):
            return leaves, interior
        frontier = [(0, zero)]
        while frontier:
            fb = np.stack([b for _, b in frontier])
            fd = np.asarray([d for d, _ in frontier], np.int64)
            # Probe both children of every frontier node at once.
            kids_b, kids_d, owner = [], [], []
            for i, (d, b) in enumerate(frontier):
                if d < self.spec.prefix_bits:
                    for bitv in (0, 1):
                        cb = np_mask_bits(b, d)
                        if bitv:
                            cb = np_flip_bit(cb[None, :],
                                             np.asarray([d]))[0]
                        kids_b.append(cb)
                        kids_d.append(d + 1)
                        owner.append(i)
            marked = np.zeros(len(kids_b), bool)
            if kids_b:
                # graftlint: disable=sync-in-loop (trie snapshot: one hash readback a trie level of the breadth-first walk)
                kk = self._node_hash(np.stack(kids_b),
                                     np.asarray(kids_d, np.int32))
                # graftlint: disable=sync-in-loop (trie snapshot: one canary get a trie level, read back to expand the frontier on the host)
                hit, val, _ = self._get(kk)
                marked = hit & (val == CANARY_TOKEN)
            has_kid = np.zeros(len(frontier), bool)
            nxt = []
            for j in np.nonzero(marked)[0]:
                has_kid[owner[j]] = True
                nxt.append((kids_d[j], kids_b[j]))
            leaf_rows = [i for i in range(len(frontier))
                         if not has_kid[i]]
            if leaf_rows:
                lb = fb[leaf_rows]
                ld = fd[leaf_rows]
                # graftlint: disable=sync-in-loop (trie snapshot: the level's leaf entries, read back once a level)
                _tk, valid, eh, ev, _eb = self.read_node_entries(lb, ld)
                for k, i in enumerate(leaf_rows):
                    ents = frozenset(
                        (eh[k][sl].astype(">u4").tobytes(),
                         int(ev[k][sl]))
                        for sl in np.nonzero(valid[k])[0])
                    leaves[(int(fd[i]),
                            np_bits_key(fb[i], int(fd[i])))] = ents
            for i in range(len(frontier)):
                if has_kid[i]:
                    interior.add((int(fd[i]),
                                  np_bits_key(fb[i], int(fd[i]))))
            frontier = nxt
        return leaves, interior


# ---------------------------------------------------------------------------
# host DHT facade over the device store (Pht ↔ SwarmStore bridge)
# ---------------------------------------------------------------------------

class StoreDht:
    """The host DHT surface (get / put / listen) the host
    :class:`~opendht_tpu_torch.indexation.pht.Pht` runs against, backed
    by the device :class:`~opendht_tpu_torch.models.storage.SwarmStore`
    and speaking :class:`DeviceIndex`'s slot-key encoding — so a
    host-built and a device-built index are views of one stored trie.

    Every get and put is a device store operation of
    :meth:`DeviceIndex._get` / :meth:`DeviceIndex._put` (a lookup — K1
    on the card — a probe or an insert, one readback).  Synchronous:
    every callback fires before the call returns, and a listen delivers
    the current values at registration and again after every put to its
    key, so the host's listener-triggered re-inserts after a split run
    eagerly; a callback returning ``False`` cancels its listen.
    ``seed`` / ``draws`` / ``device`` go to the engine."""

    def __init__(self, swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                 scfg: StoreConfig, spec: IndexSpec, seed: int = 1, *,
                 draws: Callable[[int, int], torch.Tensor] | None = None,
                 device=None):
        self._ix = DeviceIndex(swarm, cfg, store, scfg, spec, seed=seed,
                               draws=draws, device=device)
        self.spec = spec
        self._listeners: Dict[bytes, list] = {}

    @classmethod
    def over(cls, ix: "DeviceIndex") -> "StoreDht":
        """A view over an existing engine (sharing its live store): host
        ``Pht`` reads see the engine's writes and the other way round."""
        self = cls.__new__(cls)
        self._ix = ix
        self.spec = ix.spec
        self._listeners = {}
        return self

    @property
    def store(self) -> SwarmStore:
        return self._ix.store

    @staticmethod
    def _limbs(h) -> np.ndarray:
        return np.frombuffer(bytes(h), dtype=">u4").astype(np.uint32)

    def _node_values(self, h) -> list:
        """Every index value stored under trie-node hash ``h`` — the
        canary (slot 0) and each entry slot — as host values."""
        from ..core.value import Value
        from ..indexation.pht import IndexEntry, Prefix
        from ..utils.infohash import InfoHash

        keys = slot_keys(
            np.broadcast_to(self._limbs(h),
                            (MAX_NODE_ENTRY_COUNT + 1, 5)).copy(),
            np.arange(MAX_NODE_ENTRY_COUNT + 1, dtype=np.uint32))
        hit, val, pl = self._ix._get(keys.astype(np.uint32))
        vals = []
        if hit[0] and val[0] == CANARY_TOKEN:
            vals.append(Value(b"", 0, user_type=self.spec.canary_type))
        pw = self.spec.prefix_words
        for sl in range(1, MAX_NODE_ENTRY_COUNT + 1):
            if not hit[sl]:
                continue
            content = pl[sl][7:7 + pw].astype(">u4").tobytes()
            entry = IndexEntry(
                Prefix(content[:self.spec.prefix_bytes], int(pl[sl][6])),
                (InfoHash(pl[sl][0:5].astype(">u4").tobytes()),
                 int(pl[sl][5])), self.spec.value_type)
            vals.append(entry.pack_value())
        return vals

    # -- the Pht-facing surface -----------------------------------------

    def get(self, h, get_cb, done_cb=None, f=None) -> None:
        vals = self._node_values(h)
        if f is not None:
            vals = [v for v in vals if f(v)]
        if vals and get_cb is not None:
            get_cb(vals)
        if done_cb:
            done_cb(True, None)

    def put(self, h, value, done_cb=None) -> None:
        from ..indexation.pht import IndexEntry

        base = self._limbs(h)
        if value.user_type == self.spec.canary_type:
            self._ix._put(base[None, :], np.asarray([CANARY_TOKEN], np.uint32),
                          np.zeros((1, self.spec.payload_words), np.uint32))
        else:
            entry = IndexEntry.unpack_value(value)
            ehash = self._limbs(entry.value[0])
            vid = np.uint32(entry.value[1])
            # As the device engine: an existing slot of the same (hash,
            # vid) is refreshed, else the first free slot is taken.
            keys = slot_keys(
                np.broadcast_to(base, (MAX_NODE_ENTRY_COUNT, 5)).copy(),
                np.arange(1, MAX_NODE_ENTRY_COUNT + 1, dtype=np.uint32))
            hit, _val, pl = self._ix._get(keys.astype(np.uint32))
            slot = None
            for sl in range(MAX_NODE_ENTRY_COUNT):
                if hit[sl] and int(pl[sl][5]) == int(vid) \
                        and (pl[sl][0:5] == ehash).all():
                    slot = sl
                    break
            if slot is None:
                free = np.nonzero(~hit)[0]
                if free.size == 0:
                    if done_cb:
                        done_cb(False, None)
                    return
                slot = int(free[0])
            content = entry.prefix.content
            content = content + bytes(self.spec.prefix_words * 4
                                      - len(content))
            bits = np.frombuffer(content, dtype=">u4").astype(np.uint32)
            payload = np.concatenate([
                ehash, np.asarray([vid, entry.prefix.size], np.uint32),
                bits]).astype(np.uint32)[None, :]
            self._ix._put(keys[slot][None, :].astype(np.uint32),
                          entry_tokens(ehash[0], vid)[None], payload)
        if done_cb:
            done_cb(True, None)
        self._fire_listeners(bytes(h))

    def listen(self, h, cb, f=None) -> int:
        hb = bytes(h)
        entry = (cb, f)
        self._listeners.setdefault(hb, []).append(entry)
        self._deliver(hb, entry)        # current values at registration
        return len(self._listeners[hb])

    # -- listener plumbing ----------------------------------------------

    def _deliver(self, hb: bytes, entry) -> None:
        """Deliver ``hb``'s values to one listener.  A callback that
        returns ``False`` cancels its listen, as the reference's listen
        does, and the listener is off its list while its callback runs:
        ``Pht``'s split listener re-inserts from inside its callback, and
        that re-insert's canary put may land on the listened key itself,
        which an asynchronous DHT would deliver only after the callback
        had returned ``False``.  (The JAX package's adapter keeps every
        listener, so there such a put re-fires it without end.)"""
        from ..utils.infohash import InfoHash
        cb, f = entry
        vals = self._node_values(InfoHash(hb))
        if f is not None:
            vals = [v for v in vals if f(v)]
        if not vals:
            return
        live = self._listeners.get(hb, [])
        at = live.index(entry)
        live.pop(at)
        if cb(vals) is not False:
            live.insert(min(at, len(live)), entry)

    def _fire_listeners(self, hb: bytes) -> None:
        for entry in list(self._listeners.get(hb, ())):
            if entry in self._listeners.get(hb, ()):     # still listening
                # graftlint: disable=sync-in-loop (host StoreDht listener delivery: one batched get a listener to fire, the host node's own cadence)
                self._deliver(hb, entry)


# ---------------------------------------------------------------------------
# sequential oracle (pure numpy)
# ---------------------------------------------------------------------------

class PhtOracle:
    """Sequential in-memory replay of the trie rules (leaf walk, ≤ 16
    entries a leaf, divergence-point split, eager migration): the
    oracle range scans are held against.  Exact bit-level prefixes; no
    DHT, no store."""

    def __init__(self, spec: IndexSpec):
        self.spec = spec
        self.canaries: set = set()
        self.nodes: Dict[Tuple[int, bytes], list] = {}

    def _leaf_of(self, bits: np.ndarray) -> int:
        if (0, np_bits_key(bits, 0)) not in self.canaries:
            return 0
        d = 0
        while d < self.spec.prefix_bits and \
                (d + 1, np_bits_key(bits, d + 1)) in self.canaries:
            d += 1
        return d

    def insert(self, bits: np.ndarray, ehash_b: bytes, vid: int,
               _split_ok: bool = True) -> None:
        bits = np.asarray(bits, np.uint32)
        s = self.spec.prefix_bits
        self.canaries.add((0, np_bits_key(bits, 0)))
        d = self._leaf_of(bits)
        node = (d, np_bits_key(bits, d))
        ents = self.nodes.setdefault(node, [])
        ent = (ehash_b, vid, tuple(bits.tolist()))
        if any(e[0] == ehash_b and e[1] == vid for e in ents):
            return
        if len(ents) < MAX_NODE_ENTRY_COUNT or not _split_ok:
            ents.append(ent)
            return
        loc = s - 1
        for i in range(s - 1):
            kb = int(np_get_bit(bits[None, :], np.asarray([i]))[0])
            if any(int(np_get_bit(
                    np.asarray(e[2], np.uint32)[None, :],
                    np.asarray([i]))[0]) != kb for e in ents):
                loc = i + 1
                break
        if loc <= d:
            return                        # unsplittable (> 16 dups)
        for i in range(max(d, 1), loc + 1):
            self.canaries.add((i, np_bits_key(bits, i)))
            sib = np_flip_bit(bits[None, :], np.asarray([i - 1]))[0]
            self.canaries.add((i, np_bits_key(sib, i)))
        for e in list(ents):              # listener-order migration
            self.insert(np.asarray(e[2], np.uint32), e[0], e[1],
                        _split_ok=False)
        self.insert(bits, ehash_b, vid)

    def leaves(self) -> Dict[Tuple[int, bytes], FrozenSet]:
        out = {}
        for (d, kb) in self.canaries:
            bits = np.frombuffer(kb, dtype=">u4").astype(np.uint32)
            kid0 = (d + 1, np_bits_key(bits, d + 1))
            kid1 = (d + 1, np_bits_key(
                np_flip_bit(bits[None, :], np.asarray([d]))[0], d + 1))
            if d < self.spec.prefix_bits and (
                    kid0 in self.canaries or kid1 in self.canaries):
                continue
            ents = self.nodes.get((d, kb), [])
            out[(d, kb)] = frozenset((e[0], e[1]) for e in ents)
        return out

    def entries_in_range(self, lo_bits, hi_bits) -> set:
        lo = tuple(np.asarray(lo_bits, np.uint32).tolist())
        hi = tuple(np.asarray(hi_bits, np.uint32).tolist())
        out = set()
        leaf_set = self.leaves()
        for node, ents in self.nodes.items():
            if node not in leaf_set:
                continue
            for e in ents:
                if lo <= e[2] <= hi:
                    out.add((e[0], e[1]))
        return out
