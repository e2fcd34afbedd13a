"""NodeSet: a serializable set of node export records.

The port's copy of the JAX package's ``runtime/nodeset.py`` (the
Python binding's ``NodeSet``): the checkpoint / resume container for
``export_nodes()`` / ``bootstrap_nodes()`` round trips, insertion-ordered
and deduplicated, packed as MessagePack byte for byte as there.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Tuple

from ..utils.infohash import InfoHash
from ..utils.mpack import packb, unpackb
from ..utils.sockaddr import SockAddr

NodeExport = Tuple[InfoHash, SockAddr]


class NodeSet:
    def __init__(self, nodes: Iterable[NodeExport] = ()):
        self._nodes: List[NodeExport] = []
        self._seen = set()
        self.extend(nodes)

    def insert(self, nid: InfoHash, addr: SockAddr) -> bool:
        key = (bytes(nid), addr.host, addr.port)
        if key in self._seen:
            return False
        self._seen.add(key)
        self._nodes.append((nid, addr))
        return True

    def extend(self, nodes: Iterable[NodeExport]) -> None:
        for nid, addr in nodes:
            self.insert(nid, addr)

    def first(self) -> NodeExport:
        return self._nodes[0]

    def last(self) -> NodeExport:
        return self._nodes[-1]

    def __len__(self) -> int:
        return len(self._nodes)

    def __iter__(self) -> Iterator[NodeExport]:
        return iter(self._nodes)

    def __contains__(self, item: NodeExport) -> bool:
        nid, addr = item
        return (bytes(nid), addr.host, addr.port) in self._seen

    def serialize(self) -> bytes:
        return packb([
            {"id": bytes(nid), "h": addr.host, "p": addr.port,
             "f": addr.family}
            for nid, addr in self._nodes])

    @classmethod
    def deserialize(cls, blob: bytes) -> "NodeSet":
        out = cls()
        for o in unpackb(blob):
            out.insert(InfoHash(bytes(o["id"])),
                       SockAddr(o["h"], o["p"], o.get("f", 0)))
        return out

    def __repr__(self) -> str:
        return f"NodeSet({len(self._nodes)} nodes)"
