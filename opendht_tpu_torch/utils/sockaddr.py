"""Network endpoint addresses.

Replaces the reference's ``sockaddr_storage`` wrapper
(ref: include/opendht/sockaddr.h:38-71, print_addr src/utils.cpp:26-48) with
a small value type usable both for real UDP endpoints and for virtual
in-memory transport endpoints.
"""

from __future__ import annotations

import ipaddress
from typing import Tuple

AF_INET = 4
AF_INET6 = 6


class SockAddr:
    __slots__ = ("host", "port", "family")

    def __init__(self, host: str = "", port: int = 0, family: int = 0):
        self.host = host
        self.port = int(port)
        if family:
            self.family = family
        elif ":" in host:
            self.family = AF_INET6
        elif host:
            self.family = AF_INET
        else:
            self.family = 0

    @classmethod
    def from_tuple(cls, t: Tuple[str, int]) -> "SockAddr":
        return cls(t[0], t[1])

    def to_tuple(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def is_loopback(self) -> bool:
        try:
            return ipaddress.ip_address(self.host).is_loopback
        except ValueError:
            return False

    def is_private(self) -> bool:
        try:
            return ipaddress.ip_address(self.host).is_private
        except ValueError:
            return False

    def __bool__(self):
        return bool(self.host) and self.port != 0

    def __eq__(self, other):
        return (isinstance(other, SockAddr) and self.host == other.host
                and self.port == other.port and self.family == other.family)

    def __lt__(self, other):
        return (self.family, self.host, self.port) < (
            other.family, other.host, other.port)

    def __hash__(self):
        return hash((self.host, self.port, self.family))

    def __repr__(self):
        if self.family == AF_INET6:
            return f"[{self.host}]:{self.port}"
        return f"{self.host}:{self.port}"

    # -- wire form: packed binary as in compact node info -------------------
    def pack_ip(self) -> bytes:
        """4 or 16 address bytes + 2 port bytes, network order
        (ref node buffers: src/network_engine.cpp:943-992)."""
        ip = ipaddress.ip_address(self.host)
        return ip.packed + self.port.to_bytes(2, "big")

    @classmethod
    def unpack_ip(cls, data: bytes) -> "SockAddr":
        """6/18 bytes = ip+port (node buffers); 4/16 bytes = bare ip,
        port 0 (the ``sa`` echo carries no port — insertAddr,
        ref src/network_engine.cpp:604-613)."""
        if len(data) == 6:
            return cls(str(ipaddress.IPv4Address(data[:4])),
                       int.from_bytes(data[4:6], "big"), AF_INET)
        if len(data) == 18:
            return cls(str(ipaddress.IPv6Address(data[:16])),
                       int.from_bytes(data[16:18], "big"), AF_INET6)
        if len(data) == 4:
            return cls(str(ipaddress.IPv4Address(data)), 0, AF_INET)
        if len(data) == 16:
            return cls(str(ipaddress.IPv6Address(data)), 0, AF_INET6)
        raise ValueError(f"bad packed addr length {len(data)}")
