"""opendht_tpu_torch — the swarm lookup engine in PyTorch, with its
round-merge and nearest-k kernels written in CUDA C++ for Hopper, the
adversarial (chaos) engine beside it, the storage plane with SHA-1
content ids, chunked values and the integrity plane, the open-loop
serve engine (burst form, and the resident form whose macro step is one
CUDA graph), the swarm-health monitor, the PHT secondary index and the
always-on soak engine that runs serving, maintenance and monitoring in
one loop; around them the cost ledger, the metrics registry with its
Prometheus planes, and the host ``Pht`` index over the device store
(``StoreDht``); and beside them the host Kademlia node (``core/dht.py``)
with its MessagePack wire (``net/``), its in-process virtual network and
scenarios (``harness/``) and its native helpers (``native/``), pure
Python like their JAX counterparts.

The package mirrors the layout of ``opendht_tpu`` (``ops/xor_metric.py``,
``ops/kernels.py``, ``ops/sha1.py``, ``models/swarm.py``,
``models/storage.py``, ``models/chunked_values.py``,
``models/integrity.py``, ``models/serve.py``, ``models/monitor.py``,
``models/index.py``, ``models/soak.py``, ``obs/health.py``,
``obs/timeline.py``, ``obs/latency.py``, ``obs/ledger.py``,
``indexation/pht.py``, ``utils/rate_limiter.py``, ``utils/metrics.py``,
``utils/infohash.py``, ``core/``, ``net/``, ``harness/``, ``native/``,
``utils/clock.py``, ``utils/logger.py``, ``utils/sockaddr.py`` and, for
value signing, ``crypto/``) so each function has an obvious counterpart
there, and computes bit-identical results on the same state
(``tests/test_torch_*.py``).  It imports ``torch`` and nothing of JAX;
MessagePack is its own codec (``utils/mpack.py``), and
``cryptography`` is optional (signing only).

Conventions:

* every unsigned 32-bit quantity (id limbs, first-limb distances ``d0``,
  bit masks) is held as ``torch.int64`` in ``0 .. 2**32 - 1`` — see
  :mod:`opendht_tpu_torch.ops.u32`;
* routing tables stay ``torch.uint16`` (augmented rows) or
  ``torch.int32`` (plain rows), byte-equal to the JAX package's;
* node indices are ``torch.int32`` with ``-1`` for an empty slot;
* entry points take an explicit ``device`` (default ``"cuda"``) and
  explicit ``torch.Generator`` s.  On a CUDA tensor a kernel wrapper
  launches its kernel or raises; on a CPU tensor it runs the plain
  PyTorch version beside it.
"""

from .models.swarm import (  # noqa: F401
    LookupResult,
    LookupState,
    Swarm,
    SwarmConfig,
    build_swarm,
    lookup,
    lookup_recall,
    true_closest,
)
