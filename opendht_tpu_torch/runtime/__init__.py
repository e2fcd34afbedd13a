"""Runtime facade: the threaded ``DhtRunner`` over real or virtual
transports, and ``NodeSet``.  Both import without ``cryptography``: the
runner needs it only for an identity (signed or encrypted puts)."""

from .dhtrunner import DhtRunner, DhtRunnerConfig  # noqa: F401
from .nodeset import NodeSet  # noqa: F401
