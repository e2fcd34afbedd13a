"""Batched SHA-1 in PyTorch — counterpart of ``opendht_tpu/ops/sha1.py``.

The storage plane addresses values by ``key = SHA-1(payload bytes)``
(``StoreConfig.verify``), so the device must derive the same 160-bit
digests as ``hashlib``: this is SHA-1 itself, vectorized over rows.

Two entry shapes, as in the JAX module:

* **single block** (:func:`sha1_one_block` over :func:`sha1_pad_le55`)
  for messages of at most 55 bytes;
* **multi block** (:func:`sha1_blocks` over :func:`sha1_pad_blocks`, or
  :func:`sha1_words` for rows of a fixed word count) — rows whose
  message ended earlier carry their finished state through a masked
  select per block.

Words are u32 values held in int64 (:mod:`opendht_tpu_torch.ops.u32`):
every addition is masked back to 32 bits, and rotations shift a masked
value, so no right shift ever sees a negative number.  The message
schedule is kept as a rolling window of 16 words, so a compression holds
16 ``[...]`` word planes, not 80.  Messages are bytes packed big-endian
into words (byte ``k`` of a row is bits ``[8·(3-k%4), 8·(4-k%4))`` of
word ``k//4``); digests come back as ``[..., 5]`` big-endian words — the
limb form of a storage key.

These are elementwise tensor ops (the JAX module is ``jnp``, not a
Pallas kernel), so they run as PyTorch ops on the card and on the CPU.
"""

from __future__ import annotations

import torch

from .u32 import MASK32

# SHA-1 initialization vector (FIPS 180-4), shared by every entry.
_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) & MASK32) | (x >> (32 - n))


def sha1_compress(state, block: torch.Tensor):
    """One SHA-1 compression: fold a 64-byte ``block [..., 16]`` (int64
    u32 words) into ``state``, a 5-tuple of ``[...]`` word planes.
    Returns the new 5-tuple."""
    w = [block[..., i] for i in range(16)]
    h0, h1, h2, h3, h4 = state
    a, b, c, d, e = h0, h1, h2, h3, h4
    for i in range(80):
        if i >= 16:
            j = i % 16
            w[j] = _rotl(w[(i - 3) % 16] ^ w[(i - 8) % 16]
                         ^ w[(i - 14) % 16] ^ w[j], 1)
        if i < 20:
            f = (b & c) | (~b & d)
        elif i < 40 or i >= 60:
            f = b ^ c ^ d
        else:
            f = (b & c) | (b & d) | (c & d)
        tmp = (_rotl(a, 5) + f + e + _K[i // 20] + w[i % 16]) & MASK32
        e, d, c, b, a = d, c, _rotl(b, 30), a, tmp
    return tuple((h + x) & MASK32 for h, x in zip((h0, h1, h2, h3, h4),
                                                   (a, b, c, d, e)))


def _iv(shape, device) -> tuple:
    return tuple(torch.full(shape, v, dtype=torch.int64, device=device)
                 for v in _IV)


def sha1_one_block(msg: torch.Tensor) -> torch.Tensor:
    """SHA-1 of one already-padded 64-byte block per row: ``msg [...,
    16]`` big-endian words (:func:`sha1_pad_le55` builds it) →
    ``[..., 5]`` digest words."""
    return torch.stack(sha1_compress(_iv(msg.shape[:-1], msg.device), msg),
                       dim=-1)


def n_blocks_for(n_bytes: int) -> int:
    """Padded SHA-1 block count for an ``n_bytes`` message: the 0x80
    terminator and the 8-byte bit length must fit, so
    ``(n_bytes + 8) // 64 + 1`` — 55 B → 1 block, 56 B → 2."""
    return (n_bytes + 8) // 64 + 1


def sha1_blocks(blocks: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """Streaming SHA-1 over padded multi-block rows: ``blocks [..., NB,
    16]`` (:func:`sha1_pad_blocks`), ``n_blocks [...]`` each row's
    active block count (at least 1; later blocks are ignored).  Returns
    ``[..., 5]`` digest words."""
    nb = blocks.shape[-2]
    state = _iv(blocks.shape[:-2], blocks.device)
    for bi in range(nb):
        new = sha1_compress(state, blocks[..., bi, :])
        if bi == 0:
            state = new          # every message has at least one block
        else:
            live = bi < n_blocks
            state = tuple(torch.where(live, n, s) for n, s in zip(new, state))
    return torch.stack(state, dim=-1)


def _terminator(nb: torch.Tensor, gw: int) -> torch.Tensor:
    """The 0x80 byte of a row whose message is ``nb`` bytes, as it lands
    in flat word ``gw`` (0 where it lands elsewhere)."""
    lane = (nb - 4 * gw).clamp(0, 3)
    return torch.where((nb // 4) == gw, 0x80 << (8 * (3 - lane)), 0)


def sha1_pad_blocks(content: torch.Tensor, n_bytes: torch.Tensor):
    """Pad per-row messages into SHA-1 blocks: ``content [..., C]``
    packed bytes (bytes at or past ``n_bytes`` already zero), ``n_bytes
    [...]`` each row's length, at most ``4·C``.  Returns ``(blocks [...,
    NB, 16], n_blocks [...])`` with ``NB = n_blocks_for(4·C)``: the
    terminator at byte ``n_bytes``, the bit length in the last word of
    each row's last active block."""
    c_words = content.shape[-1]
    nb_static = n_blocks_for(4 * c_words)
    nb = n_bytes.to(torch.int64)
    n_blocks = (nb + 8) // 64 + 1
    words = []
    for gw in range(16 * nb_static):
        wv = content[..., gw] if gw < c_words else torch.zeros_like(nb)
        ln = torch.where((16 * n_blocks - 1) == gw, (nb * 8) & MASK32, 0)
        words.append(wv | _terminator(nb, gw) | ln)
    blocks = torch.stack(words, dim=-1)
    return blocks.reshape(blocks.shape[:-1] + (nb_static, 16)), n_blocks


def sha1_bytes(content: torch.Tensor, n_bytes: torch.Tensor) -> torch.Tensor:
    """SHA-1 of per-row variable-length messages: pad
    (:func:`sha1_pad_blocks`), then stream (:func:`sha1_blocks`)."""
    blocks, n_blocks = sha1_pad_blocks(content, n_bytes)
    return sha1_blocks(blocks, n_blocks)


def sha1_words(content: torch.Tensor) -> torch.Tensor:
    """SHA-1 of fixed-width word rows: every row is exactly ``4·W``
    bytes, ``W = content.shape[-1]`` (the storage payload's shape), so
    the padding is constant and no row needs a liveness select."""
    w = content.shape[-1]
    n_bytes = 4 * w
    nb = n_blocks_for(n_bytes)
    shape, dev = content.shape[:-1], content.device
    state = _iv(shape, dev)

    def const(v):
        return torch.full(shape, v, dtype=torch.int64, device=dev)

    for bi in range(nb):
        words = []
        for wi in range(16):
            gw = bi * 16 + wi
            if gw < w:
                words.append(content[..., gw])
            elif gw == w:                    # terminator at byte 4·W
                words.append(const(0x80000000))
            elif gw == nb * 16 - 1:
                words.append(const(8 * n_bytes))
            else:
                words.append(const(0))
        state = sha1_compress(state, torch.stack(words, dim=-1))
    return torch.stack(state, dim=-1)


def sha1_pad_le55(content: torch.Tensor, n_bytes: torch.Tensor
                  ) -> torch.Tensor:
    """Pad per-row messages of at most 55 bytes into one SHA-1 block:
    ``content [..., C]`` packed bytes (bytes past ``n_bytes`` zero) →
    ``[..., 16]`` for :func:`sha1_one_block`."""
    c_words = content.shape[-1]
    nb = n_bytes.to(torch.int64)
    words = []
    for wi in range(14):
        wv = content[..., wi] if wi < c_words else torch.zeros_like(nb)
        words.append(wv | _terminator(nb, wi))
    words.append(torch.zeros_like(nb))               # length high word
    words.append((nb * 8) & MASK32)                  # length low word
    return torch.stack(words, dim=-1)
