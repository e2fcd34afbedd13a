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
scenarios (``harness/``) and its native helpers (``native/``), the
crypto overlay ``SecureDht`` with its identities and password crypto
(``crypto/``), the threaded ``DhtRunner`` with ``NodeSet`` and the
process harness (``runtime/``, ``harness/proc_node.py``) and the
command-line tools (``tools/``), pure Python like their JAX
counterparts (Argon2i in C++, with a Python twin).

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
``cryptography`` is optional (keys, certificates and ciphers only).

The package exports the binding-parity names (``InfoHash``, ``Value``,
``Dht``, ``NodeSet``, ``Pht``, ``DhtNetwork`` ..., and, where
``cryptography`` is installed, the crypto names, ``SecureDht*`` and
``DhtRunner*``) and the swarm engine's; the swarm names load
``torch`` at first use, so importing the package loads neither torch
nor a native library.

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

# Binding-parity surface (the JAX package's ``opendht_tpu/__init__.py``).
from .utils.infohash import InfoHash  # noqa: F401
from .utils.sockaddr import SockAddr  # noqa: F401
from .core.value import Query, Select, Value, ValueType, Where  # noqa: F401
from .core.node import Node  # noqa: F401
from .core.dht import Dht, DhtConfig  # noqa: F401
from .runtime.nodeset import NodeSet  # noqa: F401
from .indexation.pht import Pht  # noqa: F401
from .harness.network import DhtNetwork  # noqa: F401
from .crypto import HAVE_CRYPTO

# name -> module; the crypto names need ``cryptography`` and raise
# ImportError without it, the swarm names load torch when first used.
_CRYPTO_NAMES = {
    "Certificate": "crypto.identity", "Identity": "crypto.identity",
    "PrivateKey": "crypto.identity", "PublicKey": "crypto.identity",
    "generate_identity": "crypto.identity",
    "SecureDht": "crypto.securedht", "SecureDhtConfig": "crypto.securedht",
    "DhtRunner": "runtime.dhtrunner", "DhtRunnerConfig": "runtime.dhtrunner",
}
_SWARM_NAMES = ("LookupResult", "LookupState", "Swarm", "SwarmConfig",
                "build_swarm", "lookup", "lookup_recall", "true_closest")


def __getattr__(name: str):
    import importlib
    if name in _CRYPTO_NAMES:
        if not HAVE_CRYPTO:
            raise ImportError(
                f"opendht_tpu_torch.{name} requires the optional "
                f"crypto dependency (cryptography)")
        mod = _CRYPTO_NAMES[name]
    elif name in _SWARM_NAMES:
        mod = "models.swarm"
    else:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value
