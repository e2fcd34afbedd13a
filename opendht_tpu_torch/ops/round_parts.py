"""Pieces of a lookup round shared by the engine and K2's plain version.

* :func:`gather_pair_windows` reads bucket-pair windows straight from
  augmented table rows;
* :func:`unpack_pair_window` decodes them into candidates, rebuilding
  each member's first-limb distance with :func:`window_d0`;
* :func:`fold_solicitations` applies a round's queried/evict outcomes to
  the frontier.

``models/swarm.py`` builds the respond and the round from them, and
``ops/kernels.fused_round_plain`` builds K2's plain version from the
same functions, so the engine and the kernel's reference cannot drift.
"""

from __future__ import annotations

import torch

from .u32 import MASK32, U32_MAX, as_i32, shl32


def gather_pair_windows(tables: torch.Tensor, rows: torch.Tensor,
                        start: torch.Tensor, k: int) -> torch.Tensor:
    """Bucket-pair windows ``tables[rows, start·3K : start·3K + 6K]`` of an
    augmented ``[N, row_w]`` u16 table → ``[..., 6K]`` int64 u16 values.
    ``rows`` must lie in ``[0, N-1]`` and ``start`` in
    ``[0, row_w // 3K - 2]``.  (An int16 view of the table: same bytes,
    fully supported indexing; masked after widening.)"""
    w3 = 3 * k
    windows = tables.view(torch.int16).unfold(1, 2 * w3, w3)
    return windows[rows, start].to(torch.int64) & 0xFFFF


def window_d0(s16: torch.Tensor, w: torch.Tensor, target0: torch.Tensor,
              nid_d0: torch.Tensor) -> torch.Tensor:
    """First-limb XOR distance rebuilt from a member's 16-bit window
    (bits ``[w, w+16)`` of its limb 0): the bits above the window are
    the solicited node's own distance bits, the window supplies the
    next 16, bits below read as zero.  Broadcasting; every left shift
    is masked back to 32 bits."""
    wu = w.clamp(0, 31)
    t16 = shl32(target0, wu) >> 16
    d16 = s16 ^ t16
    lsh = (16 - w).clamp(0, 16)
    rsh = (w - 16).clamp(0, 16)
    placed = torch.where(w <= 16, shl32(d16, lsh), d16 >> rsh)
    hm = torch.where(w > 0,
                     shl32(torch.full_like(w, MASK32), (32 - w).clamp(0, 31)),
                     0)
    return (nid_d0 & hm) | placed


def unpack_pair_window(win: torch.Tensor, w0: torch.Tensor,
                       target0: torch.Tensor, nid_d0: torch.Tensor,
                       ok: torch.Tensor, k: int):
    """Decode bucket-pair windows ``win [L,A,2,3K]`` (u16 values in
    int64; rows ``[lo K | hi K | s16 K]`` at bucket depths ``w0`` and
    ``w0 + 1``) into ``(idx [L,A,2,K] int32, d0 [L,A,2,K] int64)``,
    invalid slots -1 / all-ones.  ``target0 [L]``, ``w0``/``nid_d0``/
    ``ok`` ``[L,A]``."""
    lo, hi, s16 = win[..., :k], win[..., k:2 * k], win[..., 2 * k:]
    idx = as_i32(lo | (hi << 16))
    valid = ok[:, :, None, None] & (idx >= 0)
    wr = w0[:, :, None, None] + torch.arange(
        2, device=w0.device).view(1, 1, 2, 1)
    d0 = window_d0(s16, wr, target0[:, None, None, None],
                   nid_d0[:, :, None, None])
    return torch.where(valid, idx, -1), torch.where(valid, d0, U32_MAX)


def fold_solicitations(fr_idx: torch.Tensor, fr_d0: torch.Tensor,
                       fr_q: torch.Tensor, sel_pos: torch.Tensor,
                       q_hit: torch.Tensor, e_hit: torch.Tensor):
    """Fold a round's solicitations into the frontier ``[L,S]``: slot
    ``sel_pos`` of each answered one (``q_hit``) becomes queried, of each
    dead one (``e_hit``) is evicted (idx -1, d0 all-ones).  The JAX
    engine scatters with ``mode="drop"``; a one-hot compare of the slot
    against ``arange(S)`` needs no out-of-range index (``sel_pos = -1``
    hits nothing).  Returns ``(idx, d0, queried)``."""
    slots = torch.arange(fr_idx.shape[1], device=fr_idx.device)
    at = sel_pos[:, :, None] == slots[None, None, :]             # [L,A,S]
    queried = fr_q | (at & q_hit[:, :, None]).any(dim=1)
    evict = (at & e_hit[:, :, None]).any(dim=1)
    return (torch.where(evict, -1, fr_idx), torch.where(evict, U32_MAX, fr_d0),
            queried)
