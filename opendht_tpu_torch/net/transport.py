"""Datagram transports: the swap seam between real UDP and simulation.

The reference hard-wires UDP sockets into DhtRunner (ref:
src/dhtrunner.cpp:364-454) and passes raw fds to the engine; its callback
seam (SURVEY §1) is what makes a simulated transport possible.  Here the
seam is explicit: everything above speaks :class:`DatagramTransport`.

* :class:`VirtualNetwork` / :class:`VirtualSocket` — deterministic
  in-memory network.  Delivery is a scheduler job after a configurable
  delay; packet loss and partitions are injected by policy — the in-process
  equivalent of the reference's netns + netem harness
  (ref: python/tools/dht/virtual_network_builder.py:61-116).
* :class:`UdpTransport` — real sockets for live interop (used by
  DhtRunner's receive thread).
"""

from __future__ import annotations

import random
import socket
import threading
from typing import Callable, Dict, Optional, Tuple

from ..core.scheduler import Scheduler
from ..utils.sockaddr import AF_INET, AF_INET6, SockAddr

ReceiveCb = Callable[[bytes, SockAddr], None]


class DatagramTransport:
    def send(self, data: bytes, dest: SockAddr) -> None:  # pragma: no cover
        raise NotImplementedError

    def set_receive_callback(self, cb: ReceiveCb) -> None:
        self._cb = cb

    def local_addr(self) -> SockAddr:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class VirtualNetwork:
    """An in-memory packet-switched network driven by one scheduler.

    Models the netem knobs (delay/jitter/loss) and partitions; every
    delivery is deterministic given the rng seed.
    """

    def __init__(self, scheduler: Scheduler, delay: float = 0.005,
                 jitter: float = 0.0, loss: float = 0.0,
                 seed: int = 42):
        self.scheduler = scheduler
        self.delay = delay
        self.jitter = jitter
        self.loss = loss
        self.rng = random.Random(seed)
        self._endpoints: Dict[Tuple[str, int], "VirtualSocket"] = {}
        self._partitions: set = set()   # hosts currently unreachable
        self.packets_sent = 0
        self.packets_dropped = 0
        self.bytes_sent = 0

    def socket(self, host: str, port: int) -> "VirtualSocket":
        s = VirtualSocket(self, SockAddr(host, port))
        self._endpoints[(host, port)] = s
        return s

    def unregister(self, addr: SockAddr) -> None:
        self._endpoints.pop((addr.host, addr.port), None)

    def partition(self, host: str, isolated: bool = True) -> None:
        """Isolate/restore a host (the node-kill / net-split knob)."""
        if isolated:
            self._partitions.add(host)
        else:
            self._partitions.discard(host)

    def deliver(self, data: bytes, src: SockAddr, dest: SockAddr) -> None:
        self.packets_sent += 1
        self.bytes_sent += len(data)
        if (src.host in self._partitions or dest.host in self._partitions
                or (self.loss and self.rng.random() < self.loss)):
            self.packets_dropped += 1
            return
        delay = self.delay
        if self.jitter:
            delay += self.rng.uniform(0, self.jitter)

        def _arrive(data=data, src=src, dest_key=(dest.host, dest.port)):
            ep = self._endpoints.get(dest_key)
            if ep is not None and ep._cb is not None:
                ep._cb(data, src)

        self.scheduler.add(self.scheduler.time() + delay, _arrive)


class VirtualSocket(DatagramTransport):
    def __init__(self, net: VirtualNetwork, addr: SockAddr):
        self.net = net
        self.addr = addr
        self._cb: Optional[ReceiveCb] = None

    def send(self, data: bytes, dest: SockAddr) -> None:
        self.net.deliver(data, self.addr, dest)

    def local_addr(self) -> SockAddr:
        return self.addr

    def close(self) -> None:
        self.net.unregister(self.addr)


class UdpTransport(DatagramTransport):
    """Real UDP socket with a background receive thread.

    The receive thread pushes packets into a callback; binding, 250 ms
    select tick and the rcv queue mirror the reference's receive loop
    (ref: src/dhtrunner.cpp:404-454).
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 0, af: int = AF_INET):
        fam = socket.AF_INET if af == AF_INET else socket.AF_INET6
        self.sock = socket.socket(fam, socket.SOCK_DGRAM)
        if af == AF_INET6:
            self.sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 1)
        self.sock.bind((host, port))
        self.sock.settimeout(0.25)
        self.af = af
        self._cb: Optional[ReceiveCb] = None
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    def _recv_loop(self) -> None:
        while self._running:
            try:
                data, src = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if self._cb is not None:
                self._cb(data, SockAddr(src[0], src[1]))

    def send(self, data: bytes, dest: SockAddr) -> None:
        try:
            self.sock.sendto(data, dest.to_tuple())
        except OSError:
            pass

    def local_addr(self) -> SockAddr:
        host, port = self.sock.getsockname()[:2]
        return SockAddr(host, port)

    def close(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
        self.sock.close()
