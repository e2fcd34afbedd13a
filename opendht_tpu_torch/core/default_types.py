"""Built-in value types 0-8.

Re-design of the reference default types (ref:
include/opendht/default_types.h, src/default_types.cpp:86-106 type table):

* 0 USER_DATA      — plain user bytes, 10 min TTL
* 1 DhtMessage     — service messages, 5 min TTL
* 2 IpServiceAnnouncement — service endpoint; store policy rewrites the
  stored address to the sender's observed address (src/default_types.cpp:70-84)
* 3 ImMessage      — instant messages (used by dhtchat)
* 4 TrustRequest
* 5 IceCandidates
* 8 CERTIFICATE    — 7-day TTL, only storable at its own key id
  (ref: include/opendht/securedht.h:166-183)
"""

from __future__ import annotations

from ..utils.mpack import packb, unpackb

from ..utils.sockaddr import SockAddr
from .value import USER_DATA, Value, ValueType, default_store_policy


class DhtMessage:
    TYPE = ValueType(1, "DHT message", 5 * 60)

    def __init__(self, service: str = "", data: bytes = b""):
        self.service = service
        self.data = data

    def pack(self) -> bytes:
        return packb({"s": self.service, "d": self.data})

    @classmethod
    def unpack(cls, blob: bytes) -> "DhtMessage":
        o = unpackb(blob, strict_map_key=True)
        return cls(o.get("s", ""), bytes(o.get("d", b"")))


def _ip_service_store_policy(key, value: Value, remote_id, from_addr) -> bool:
    """Rewrite announced address to the sender's observed address
    (ref: src/default_types.cpp:70-84)."""
    if not default_store_policy(key, value, remote_id, from_addr):
        return False
    try:
        ann = IpServiceAnnouncement.unpack(value.data)
    except Exception:
        return False
    if not ann.addr.host and isinstance(from_addr, SockAddr):
        ann.addr = SockAddr(from_addr.host, ann.addr.port or from_addr.port)
        value.data = ann.pack()
    return True


class IpServiceAnnouncement:
    TYPE = ValueType(2, "Internet Service Announcement", 15 * 60,
                     store_policy=_ip_service_store_policy)

    def __init__(self, addr: SockAddr = None):
        self.addr = addr or SockAddr()

    def pack(self) -> bytes:
        return packb({"h": self.addr.host, "p": self.addr.port})

    @classmethod
    def unpack(cls, blob: bytes) -> "IpServiceAnnouncement":
        o = unpackb(blob, strict_map_key=True)
        return cls(SockAddr(o.get("h", ""), o.get("p", 0)))


class ImMessage:
    TYPE = ValueType(3, "IM message", 100 * 24 * 3600)

    def __init__(self, msg_id: int = 0, message: str = "", date: int = 0):
        self.id = msg_id
        self.message = message
        self.date = date

    def pack(self) -> bytes:
        return packb({"id": self.id, "im": self.message,
                              "d": self.date})

    @classmethod
    def unpack(cls, blob: bytes) -> "ImMessage":
        o = unpackb(blob)
        return cls(o.get("id", 0), o.get("im", ""), o.get("d", 0))


TRUST_REQUEST = ValueType(4, "Certificate trust request", 100 * 24 * 3600)
ICE_CANDIDATES = ValueType(5, "ICE candidates", 10 * 60)
CERTIFICATE_TYPE_ID = 8


class TrustRequest:
    """Connectivity/trust handshake payload
    (ref: include/opendht/default_types.h:105-140)."""

    TYPE = TRUST_REQUEST

    def __init__(self, service: str = "", payload: bytes = b"",
                 confirm: bool = False):
        self.service = service
        self.payload = bytes(payload)
        self.confirm = confirm

    def pack(self) -> bytes:
        return packb({"s": self.service, "d": self.payload,
                              "c": self.confirm})

    @classmethod
    def unpack(cls, blob: bytes) -> "TrustRequest":
        o = unpackb(blob)
        return cls(o.get("s", ""), bytes(o.get("d", b"")),
                   bool(o.get("c", False)))


class IceCandidates:
    """ICE negotiation blob (ref: default_types.h:142-180)."""

    TYPE = ICE_CANDIDATES

    def __init__(self, msg_id: int = 0, ice_data: bytes = b""):
        self.id = msg_id
        self.ice_data = bytes(ice_data)

    def pack(self) -> bytes:
        return packb({"id": self.id, "ice": self.ice_data})

    @classmethod
    def unpack(cls, blob: bytes) -> "IceCandidates":
        o = unpackb(blob)
        return cls(o.get("id", 0), bytes(o.get("ice", b"")))

DEFAULT_TYPES = [
    USER_DATA,
    DhtMessage.TYPE,
    IpServiceAnnouncement.TYPE,
    ImMessage.TYPE,
    TRUST_REQUEST,
    ICE_CANDIDATES,
]
