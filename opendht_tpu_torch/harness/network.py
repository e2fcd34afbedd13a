"""In-process deterministic DHT cluster manager.

The framework's equivalent of the reference's netns test cluster stack
(ref: python/tools/dht/network.py ``DhtNetwork``/``DhtNetworkSubProcess``
and python/tools/dht/virtual_network_builder.py): N Dht cores share one
virtual clock / scheduler / packet network, so whole-swarm scenarios
(put/get/listen, churn, persistence) run deterministically, with
simulated seconds passing in real milliseconds.

Differences from the reference: no subprocess/netns split is needed —
the virtual transport gives loss/latency injection in-process (the
``netem`` equivalent, ref virtual_network_builder.py:61-116), and the
cluster scales to thousands of in-process nodes.
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional

from ..core.dht import Dht, DhtConfig
from ..core.scheduler import Scheduler
from ..net.transport import VirtualNetwork
from ..utils.clock import VirtualClock
from ..utils.infohash import InfoHash
from ..utils.sockaddr import SockAddr


class DhtNetwork:
    """A cluster of in-process Dht nodes on one virtual network."""

    def __init__(self, n: int, seed: int = 1, delay: float = 0.01,
                 loss: float = 0.0, **dht_kwargs):
        self.clock = VirtualClock()
        self.scheduler = Scheduler(self.clock)
        self.net = VirtualNetwork(self.scheduler, delay=delay, loss=loss,
                                  seed=seed)
        self.nodes: List[Dht] = []
        self.seed = seed
        self._spawned = 0
        for _ in range(n):
            self.add_node(**dht_kwargs)

    # -- membership -----------------------------------------------------
    def _host(self, i: int) -> str:
        return f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"

    def _node_wiring(self, i: Optional[int]):
        """Shared per-node wiring: (index, socket, node id, rng)."""
        if i is None:
            i = self._spawned
        self._spawned = max(self._spawned, i + 1)
        sock = self.net.socket(self._host(i), 4222)
        node_id = InfoHash.get(f"node-{self.seed}-{i}")
        rng = random.Random(self.seed * 10007 + i)
        return i, sock, node_id, rng

    def _host6(self, i: int) -> str:
        return f"2001:db9::{i + 1:x}"

    def add_node(self, i: Optional[int] = None, family: str = "ipv4",
                 **dht_kwargs) -> Dht:
        """Add a node; ``family``: "ipv4", "ipv6", or "dual" — the
        netns harness's v4/v6 address assignment
        (ref python/tools/dht/virtual_network_builder.py:61-116).
        Dual-stack nodes fork every op into per-family searches with a
        merged done callback (ref src/dht.cpp:1969-2011)."""
        i, sock, node_id, rng = self._node_wiring(i)
        sock4 = sock if family in ("ipv4", "dual") else None
        sock6 = None
        if family in ("ipv6", "dual"):
            sock6 = self.net.socket(self._host6(i), 4222)
        if sock4 is None:
            self.net.unregister(sock.local_addr())
        dht = Dht(sock4, sock6, DhtConfig(node_id=node_id),
                  scheduler=self.scheduler, rng=rng, **dht_kwargs)
        self.nodes.append(dht)
        return dht

    def add_secure_node(self, identity=None, i: Optional[int] = None):
        """Add a SecureDht node (crypto overlay) to the same network."""
        from ..crypto.securedht import SecureDht, SecureDhtConfig
        i, sock, node_id, rng = self._node_wiring(i)
        cfg = SecureDhtConfig(DhtConfig(node_id=node_id), identity)
        dht = SecureDht(sock, None, cfg, scheduler=self.scheduler, rng=rng)
        self.nodes.append(dht)
        return dht

    def addr_of(self, dht: Dht) -> SockAddr:
        t = dht.engine.t4 or dht.engine.t6
        return t.local_addr()

    def addr6_of(self, dht: Dht) -> SockAddr:
        return dht.engine.t6.local_addr()

    def bootstrap_all(self, to: int = 0) -> None:
        """Everyone learns about node ``to``."""
        target = self.nodes[to]
        addr = self.addr_of(target)
        for d in self.nodes:
            if d is not target:
                d.insert_node(target.myid, addr)

    def interconnect(self) -> None:
        """Full mesh knowledge — for tests that skip discovery."""
        for a in self.nodes:
            for b in self.nodes:
                if a is not b:
                    a.insert_node(b.myid, self.addr_of(b))

    # -- fault injection (netem / node-kill equivalents) ----------------
    def _hosts_of(self, dht: Dht) -> List[str]:
        return [t.local_addr().host
                for t in (dht.engine.t4, dht.engine.t6) if t is not None]

    def kill(self, dht: Dht) -> None:
        """Partition a node away on every family (the node-kill knob,
        ref: DhtNetworkSubProcess shutdown_node network.py:50-64)."""
        for h in self._hosts_of(dht):
            self.net.partition(h, True)

    def revive(self, dht: Dht) -> None:
        for h in self._hosts_of(dht):
            self.net.partition(h, False)

    def remove_node(self, dht: Dht) -> None:
        """Kill and forget a node (graceful-removal equivalent).

        Shuts the core down and unregisters its sockets so removed
        nodes stop scheduling maintenance against the shared
        scheduler."""
        addrs = [t.local_addr()
                 for t in (dht.engine.t4, dht.engine.t6) if t is not None]
        self.kill(dht)
        dht.shutdown()
        for a in addrs:
            self.net.unregister(a)
        self.nodes.remove(dht)

    def replace_cluster(self, count: Optional[int] = None,
                        bootstrap: int = 0) -> List[Dht]:
        """Kill ``count`` random nodes and spawn fresh replacements —
        the reference's cluster replacement (ref: WorkBench
        python/tools/benchmark.py:100-120, tests.py:869-875)."""
        rng = random.Random(self.seed + len(self.nodes))
        count = count if count is not None else max(1, len(self.nodes) // 4)
        victims = rng.sample([n for i, n in enumerate(self.nodes)
                              if i != bootstrap],
                             min(count, len(self.nodes) - 1))
        for v in victims:
            self.remove_node(v)
        fresh = []
        boot_addr = self.addr_of(self.nodes[bootstrap])
        boot_id = self.nodes[bootstrap].myid
        for _ in range(len(victims)):
            d = self.add_node()
            d.insert_node(boot_id, boot_addr)
            fresh.append(d)
        return fresh

    def resize(self, n: int, bootstrap: int = 0) -> None:
        """Grow/shrink the cluster (ref: DhtNetwork.resize
        python/tools/dht/network.py:420-445)."""
        while len(self.nodes) > n:
            self.remove_node(self.nodes[-1])
        boot_addr = self.addr_of(self.nodes[bootstrap])
        boot_id = self.nodes[bootstrap].myid
        while len(self.nodes) < n:
            d = self.add_node()
            d.insert_node(boot_id, boot_addr)

    def warmup(self, min_good: int = 4, timeout: float = 120.0) -> bool:
        """Run virtual time until the mesh has converged (most nodes
        know several good peers).  Goodness needs request/reply cycles
        from maintenance, so a fresh bootstrap-star takes ~30-60
        simulated seconds to become a usable mesh."""
        from ..utils.sockaddr import AF_INET

        def ready():
            goods = [d.get_nodes_stats(AF_INET)[0] for d in self.nodes]
            return sorted(goods)[len(goods) // 4] >= min_good

        return self.run_until(ready, timeout, step=5.0)

    # -- virtual time ---------------------------------------------------
    def run(self, duration: float, max_step: float = 0.25) -> None:
        """Advance virtual time, running all due jobs."""
        end = self.clock.now() + duration
        while self.clock.now() < end:
            nxt = self.scheduler.run()
            if nxt >= end:
                self.clock.set(end)
                break
            self.clock.set(min(end, max(nxt, self.clock.now() + 1e-6)))
        self.scheduler.run()

    def run_until(self, pred: Callable[[], bool], timeout: float = 30.0,
                  step: float = 0.05) -> bool:
        end = self.clock.now() + timeout
        while self.clock.now() < end:
            if pred():
                return True
            self.run(step)
        return pred()
