"""The integrity plane: content-addressed value ids and the pipelined
host signature stage.

Counterpart of ``opendht_tpu/models/integrity.py``:

* **content ids** — a value's id is ``SHA-1(payload bytes)``
  (:func:`content_ids`, on the card or the CPU with
  :func:`opendht_tpu_torch.ops.sha1.sha1_words`; :func:`content_ids_host`
  is its ``hashlib`` twin).  With ``StoreConfig.verify`` the storage
  plane re-derives the id of every arriving payload and of every
  candidate replica a get reads (:mod:`opendht_tpu_torch.models.storage`);
  :func:`forge_payloads` makes the corrupted payloads that defence is
  measured against;
* **the signature stage** — RSA verifies stay on the host, batched:
  :class:`SignatureStage` takes whole harvested batches and checks them
  on a worker thread (OpenSSL releases the GIL, so the checks overlap
  the next device burst).  ``cryptography`` is optional: without it
  the stage still builds, with ``available == False``, counts what it
  is given and reports null figures.

Random draws are arguments: :func:`forge_payloads` takes the three draws
(which rows, which word, which bit) as tensors, or draws them from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..crypto import HAVE_CRYPTO
from ..ops.sha1 import sha1_words
from ..ops.u32 import MASK32


def content_ids(payloads: torch.Tensor) -> torch.Tensor:
    """``payloads [..., W]`` u32 words (word j = bytes 4j..4j+3
    big-endian, as the store holds them) → ``[..., 5]`` SHA-1 digest
    limbs: the storage key of a content-addressed announce."""
    return sha1_words(payloads)


def content_ids_host(payloads) -> np.ndarray:
    """The ``hashlib`` twin of :func:`content_ids` for ``[P, W]`` uint32
    rows (numpy or a tensor)."""
    if isinstance(payloads, torch.Tensor):
        payloads = payloads.cpu().numpy()
    pl = np.ascontiguousarray(np.asarray(payloads).astype(np.uint32))
    if pl.ndim == 1:
        pl = pl[None]
    out = np.zeros((pl.shape[0], 5), np.uint32)
    be = pl.astype(">u4")
    for i in range(pl.shape[0]):
        d = hashlib.sha1(be[i].tobytes()).digest()
        out[i] = np.frombuffer(d, dtype=">u4").astype(np.uint32)
    return out


def forge_payloads(payloads: torch.Tensor, hit: torch.Tensor | None = None,
                   col: torch.Tensor | None = None,
                   bit: torch.Tensor | None = None, *,
                   flip_frac: float = 1.0,
                   generator: torch.Generator | None = None):
    """Flip one bit in a ``flip_frac`` share of the rows of ``payloads
    [P, W]`` (a corrupted or substituted value whose claimed id no
    longer matches).  ``hit [P]`` bool, ``col [P]`` (word) and ``bit
    [P]`` (0-31) are taken as given; any left out is drawn with
    ``generator``.  Returns the mutated ``[P, W]`` tensor and ``hit``."""
    pl = payloads
    p, w = pl.shape
    dev = pl.device
    if hit is None:
        hit = torch.rand((p,), generator=generator, device=dev) < flip_frac
    if col is None:
        col = torch.randint(0, max(w, 1), (p,), generator=generator,
                            device=dev)
    if bit is None:
        bit = torch.randint(0, 32, (p,), generator=generator, device=dev)
    hit = hit.to(dev)
    if w == 0:
        return pl, hit
    # One write a row (no repeated index); the column is clipped as the
    # JAX scatter's index is.
    mask = torch.zeros((p, w), dtype=torch.int64, device=dev)
    mask[torch.arange(p, device=dev), col.to(dev).long().clamp(0, w - 1)] = (
        torch.ones((p,), dtype=torch.int64, device=dev)
        << bit.to(dev).long()) & MASK32
    return torch.where(hit[:, None], pl ^ mask, pl), hit


# ---------------------------------------------------------------------------
# pipelined host signature stage
# ---------------------------------------------------------------------------

class SignatureStage:
    """Batched signature checks on a worker thread.

    :meth:`submit` enqueues one harvested batch and returns at once; the
    worker runs the RSA verifies while the caller dispatches the next
    device burst; :meth:`drain` joins it and returns the stats, with
    ``verified + failed == submitted``.  Without ``cryptography`` the
    stage has ``available == False``: submissions are
    counted and the crypto figures are ``None``.
    """

    def __init__(self):
        self.available = HAVE_CRYPTO
        self.submitted = 0
        self.batches = 0
        self._verified = 0
        self._failed = 0
        self._verify_wall = 0.0
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._drained = False
        self._worker: Optional[threading.Thread] = None
        if self.available:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def _run(self) -> None:
        from ..crypto.signing import verify_values_batch
        while True:
            batch = self._q.get()
            if batch is None:
                return
            t0 = time.perf_counter()
            ok = sum(verify_values_batch(batch))
            dt = time.perf_counter() - t0
            with self._lock:
                self._verified += ok
                self._failed += len(batch) - ok
                self._verify_wall += dt

    def submit(self, values: List) -> None:
        """Enqueue one batch.  A drained stage refuses: its worker has
        exited, and a batch counted but never checked would break the
        conservation.  The check, the counters and the enqueue happen
        under one lock, so no batch slips past a concurrent drain."""
        with self._lock:
            if self._drained:
                raise RuntimeError(
                    "SignatureStage.submit after drain: the worker "
                    "has exited — build a fresh stage per measured "
                    "leg")
            self.submitted += len(values)
            self.batches += 1
            if self.available and values:
                self._q.put(list(values))

    def drain(self) -> dict:
        """Join the worker and return the stats (null crypto figures
        without the optional packages).  The stop sentinel is enqueued
        once, under the lock; every caller joins, outside it."""
        with self._lock:
            first = not self._drained
            self._drained = True
            worker = self._worker
            if first and worker is not None:
                self._q.put(None)
        if worker is not None:
            worker.join()
        with self._lock:
            self._worker = None
            if not self.available:
                return {"available": False, "submitted": self.submitted,
                        "batches": self.batches, "verified": None,
                        "failed": None, "verify_wall_s": None,
                        "verifies_per_sec": None}
            vps = ((self._verified + self._failed) / self._verify_wall
                   if self._verify_wall > 0 else None)
            return {"available": True, "submitted": self.submitted,
                    "batches": self.batches,
                    "verified": self._verified,
                    "failed": self._failed,
                    "verify_wall_s": round(self._verify_wall, 6),
                    "verifies_per_sec": (round(vps, 1)
                                         if vps is not None else None)}


def make_signed_values(n: int, key_length: int = 2048):
    """``n`` host values signed by a fresh identity → ``(values,
    identity)``, or ``(None, None)`` without the optional packages."""
    if not HAVE_CRYPTO:
        return None, None
    from ..crypto.identity import generate_identity
    from ..crypto.signing import sign_value
    from ..core.value import Value
    ident = generate_identity("auth-bench", key_length=key_length)
    vals = []
    for i in range(n):
        v = Value(bytes([i & 0xFF]) * 64, value_id=i + 1)
        sign_value(ident.key, v)
        vals.append(v)
    return vals, ident
