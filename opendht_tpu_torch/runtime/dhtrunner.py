"""DhtRunner: the thread-safe runtime facade over SecureDht.

The port's copy of the JAX package's ``runtime/dhtrunner.py``; a
re-design of the reference ``class DhtRunner`` (ref: src/dhtrunner.cpp,
include/opendht/dhtrunner.h:52-415):

* every public operation becomes a closure pushed onto one of two
  queues — ``pending_ops_prio`` (always drained) or ``pending_ops``
  (drained once Connected, or once bootstrap has given up) — executed
  on the loop thread (dhtrunner.cpp:306-322, dhtrunner.h:403-404);
* the loop thread drains ops, feeds received packets to
  ``Dht::periodic``, runs the scheduler, and sleeps until the next
  scheduled wakeup or a condition-variable notification
  (``loop_`` dhtrunner.cpp:306-361);
* packet receive happens on the transport's own thread and is handed
  over through a queue (dhtrunner.cpp:404-454);
* continuous bootstrap: while Disconnected, retry the saved bootstrap
  list every 10 s, most recently added first
  (``tryBootstrapCoutinuously`` dhtrunner.cpp:620-677);
* ``shutdown`` flushes storage announcements then stops; ``join``
  stops threads (dhtrunner.cpp:119-154).

Differences from the reference: transports are injectable (UDP for
real networking, virtual for tests), so the runner is testable without
sockets; futures are ``concurrent.futures.Future``.
"""

from __future__ import annotations

import socket as _socket
import threading
import time as _time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

from ..core.dht import DoneCallback, GetCallback, NodeStatus
from ..core.scheduler import Scheduler
from ..core.value import Filter, Value, Where
from ..crypto.identity import Identity
from ..crypto.securedht import SecureDht, SecureDhtConfig
from ..net.transport import UdpTransport
from ..utils.clock import SteadyClock
from ..utils.infohash import InfoHash
from ..utils.logger import NONE, Logger
from ..utils.mpack import packb, unpackb
from ..utils.sockaddr import AF_INET, AF_INET6, SockAddr

BOOTSTRAP_PERIOD = 10.0  # s, ref: dhtrunner.h:365
# After this many fruitless retry rounds the runner "gives up": the
# normal-op gate opens (ref semantics "Connected-or-gave-up",
# dhtrunner.cpp:316-317) so queued ops run against the empty table and
# their done-callbacks fire with ok=False instead of hanging forever.
BOOTSTRAP_MAX_TRIES = 6


class DhtRunnerConfig:
    """ref: DhtRunner::Config dhtrunner.h:296-299."""

    def __init__(self, dht_config: Optional[SecureDhtConfig] = None,
                 threaded: bool = True):
        self.dht_config = dht_config or SecureDhtConfig()
        self.threaded = threaded


class DhtRunner:
    def __init__(self, logger: Logger = NONE):
        self.log = logger
        self.dht: Optional[SecureDht] = None
        self.scheduler: Optional[Scheduler] = None
        self._t4: Optional[UdpTransport] = None
        self._t6: Optional[UdpTransport] = None

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._ops: deque = deque()
        self._ops_prio: deque = deque()
        self._rcv: deque = deque()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._threaded = True

        self._bootstrap_nodes: List[Tuple[str, int]] = []
        self._bootstrapping = False
        self._bootstrap_job = None
        self._bootstrap_tries = 0
        self._bootstrap_gen = 0

        self.on_status_changed: Optional[Callable[[str, str], None]] = None
        self._status4 = NodeStatus.Disconnected
        self._status6 = NodeStatus.Disconnected

    # ------------------------------------------------------------------ #
    # lifecycle                                                          #
    # ------------------------------------------------------------------ #

    def run(self, port: int = 4222,
            config: Optional[DhtRunnerConfig] = None,
            identity: Optional[Identity] = None,
            bind4: str = "0.0.0.0", bind6: Optional[str] = None,
            transport4=None, transport6=None,
            scheduler: Optional[Scheduler] = None) -> None:
        """Start the node (ref: DhtRunner::run dhtrunner.cpp:59-117).

        Binds UDP sockets unless explicit transports are given.

        The running check-and-claim is atomic (two threads racing
        ``run()`` must not both pass an unlocked ``if self._running``
        guard and double-build the node); shared state publishes under
        the lock BEFORE the transports start delivering packets, and
        nothing slow (socket bind, transport start, thread start) runs
        while it is held.
        """
        with self._lock:
            if self._running:
                return
            self._running = True            # claimed; we build it
        try:
            config = config or DhtRunnerConfig()
            if identity is not None:
                config.dht_config.identity = identity
            sched = scheduler or Scheduler(SteadyClock())
            if transport4 is None and transport6 is None:
                transport4 = UdpTransport(bind4, port, AF_INET)
                if bind6 is not None:
                    transport6 = UdpTransport(bind6, port, AF_INET6)
            dht = SecureDht(transport4, transport6, config.dht_config,
                            scheduler=sched, logger=self.log)
            dht.on_status_changed = self._on_dht_status
            with self._lock:
                self._threaded = config.threaded
                self.scheduler = sched
                self._t4, self._t6 = transport4, transport6
                self.dht = dht

            for t in (transport4, transport6):
                if t is None:
                    continue
                t.set_receive_callback(self._on_packet)
                start = getattr(t, "start", None)
                if start is not None:
                    start()
        except BaseException:
            # A failed build (port in use, bad bind, ...) must release
            # the claim, or every later run() would return silently at
            # the guard with the node permanently bricked.
            with self._lock:
                self._running = False
            for t in (transport4, transport6):
                if t is not None:
                    try:
                        t.close()
                    except Exception:
                        pass
            raise

        thread = None
        if config.threaded:
            thread = threading.Thread(
                target=self._loop_forever, name="dht-loop", daemon=True)
        with self._lock:
            alive = self._running
            if alive and thread is not None:
                self._thread = thread
        if not alive:
            # A concurrent join() stopped the node mid-build: it saw
            # no thread and no transports, so unwind what we just
            # started instead of leaving bound sockets with no loop.
            for t in (transport4, transport6):
                if t is not None:
                    t.close()
            return
        if thread is not None:
            thread.start()

    def shutdown(self, done_cb: Optional[Callable[[], None]] = None,
                 stop: bool = False) -> None:
        """Flush storage announces (ref: dhtrunner.cpp:119-137)."""
        def op():
            with self._lock:
                dht = self.dht
            if dht is not None:
                dht.shutdown(done_cb)
        self._post(op, prio=True)
        if stop:
            self.join()

    def join(self) -> None:
        """Stop the loop thread and close transports
        (ref: DhtRunner::join dhtrunner.cpp:139-154).

        Pending priority ops (e.g. the shutdown storage flush) are
        drained before the loop stops so ``shutdown(); join()`` cannot
        silently drop the flush."""
        with self._lock:
            thread = self._thread
        if thread is not None and thread.is_alive():
            end = _time.monotonic() + 5
            while _time.monotonic() < end:
                with self._lock:
                    if not self._ops_prio and not self._rcv:
                        break
                _time.sleep(0.01)
        with self._cv:
            self._running = False
            self._cv.notify_all()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)
        for t in (self._t4, self._t6):
            if t is not None:
                t.close()

    def is_running(self) -> bool:
        return self._running

    def get_id(self) -> Optional[InfoHash]:
        return self.dht.get_id() if self.dht else None

    def get_node_id(self) -> Optional[InfoHash]:
        return self.dht.myid if self.dht else None

    def get_bound_port(self) -> int:
        t = self._t4 or self._t6
        return t.local_addr().port if t is not None else 0

    # ------------------------------------------------------------------ #
    # loop                                                               #
    # ------------------------------------------------------------------ #

    def _on_packet(self, data: bytes, from_addr: SockAddr) -> None:
        with self._cv:
            self._rcv.append((data, from_addr))
            self._cv.notify_all()

    def _post(self, op: Callable[[], None], prio: bool = False) -> None:
        with self._cv:
            (self._ops_prio if prio else self._ops).append(op)
            self._cv.notify_all()

    def loop(self) -> float:
        """One manual iteration (non-threaded mode); returns next wakeup
        delay in seconds (ref: DhtRunner::loop dhtrunner.cpp:306-361)."""
        with self._lock:
            prio = list(self._ops_prio)
            self._ops_prio.clear()
            # Normal ops wait for Connected (or bootstrap gave up),
            # ref: dhtrunner.cpp:316-317.
            ready = (self._status4 == NodeStatus.Connected
                     or self._status6 == NodeStatus.Connected
                     or not self._bootstrap_nodes
                     or not self._bootstrapping)
            ops = list(self._ops) if ready else []
            if ready:
                self._ops.clear()
            pkts = list(self._rcv)
            self._rcv.clear()
        for op in prio:
            op()
        for op in ops:
            op()
        wakeup = self.scheduler.clock.now() + 0.25
        for data, addr in pkts:
            wakeup = self.dht.periodic(data, addr)
        wakeup = self.dht.periodic(None, None)
        return max(0.0, wakeup - self.scheduler.clock.now())

    def _loop_forever(self) -> None:
        while True:
            with self._cv:
                if not self._running:
                    break
            delay = self.loop()
            with self._cv:
                if not self._running:
                    break
                if not (self._ops_prio or self._rcv or self._ops):
                    self._cv.wait(timeout=min(delay, 0.25))

    # ------------------------------------------------------------------ #
    # status / bootstrap                                                 #
    # ------------------------------------------------------------------ #

    def _on_dht_status(self, s4: str, s6: str) -> None:
        # Status lands from the loop thread; get_status()/loop() read
        # it from API threads — same lock on both sides.
        with self._lock:
            self._status4, self._status6 = s4, s6
        status = self.get_status()
        if status == NodeStatus.Disconnected and self._bootstrap_nodes:
            self._try_bootstrap_continuously()
        elif status == NodeStatus.Connected:
            with self._lock:
                self._bootstrapping = False
        if self.on_status_changed:
            self.on_status_changed(s4, s6)

    def get_status(self) -> str:
        with self._lock:
            s4, s6 = self._status4, self._status6
        if NodeStatus.Connected in (s4, s6):
            return NodeStatus.Connected
        if NodeStatus.Connecting in (s4, s6):
            return NodeStatus.Connecting
        return NodeStatus.Disconnected

    def bootstrap(self, host: str, port: int = 4222,
                  done_cb: Optional[Callable[[bool], None]] = None) -> None:
        """Add a bootstrap node and ping it
        (ref: DhtRunner::bootstrap dhtrunner.cpp:704-737)."""
        self._bootstrap_nodes.append((host, port))

        def op():
            for addr in self._resolve(host, port):
                self.dht.ping_node(
                    addr, (lambda ok: done_cb(ok)) if done_cb else None)
        self._post(op, prio=True)
        # Arm the 10 s retry chain right away: the initial state is
        # Disconnected and _on_dht_status only fires on *changes*, so a
        # dropped first ping would otherwise strand the node forever.
        if self.get_status() == NodeStatus.Disconnected:
            self._try_bootstrap_continuously()

    def bootstrap_nodes(self,
                        nodes: List[Tuple[InfoHash, SockAddr]]) -> None:
        """Re-insert exported nodes without pinging
        (ref: dhtrunner.cpp:739-749)."""
        def op():
            for nid, addr in nodes:
                self.dht.insert_node(nid, addr)
        self._post(op, prio=True)

    def _try_bootstrap_continuously(self) -> None:
        """ref: tryBootstrapCoutinuously dhtrunner.cpp:620-677.

        Unlike the reference (which retries forever), after
        ``BOOTSTRAP_MAX_TRIES`` fruitless rounds the runner gives up:
        ``_bootstrapping`` clears, which opens the normal-op gate in
        :meth:`loop`, so queued ops (and their futures) complete with
        failure instead of hanging on an unreachable bootstrap.

        Armed from BOTH the loop thread (status change) and API
        threads (:meth:`bootstrap`), so the check-and-arm is atomic
        under the runner lock: an unlocked ``if self._bootstrapping``
        guard would let two racing callers double-arm the chain and
        double-count tries.  The lock is scoped to the flag edits only:
        ``_post``/``cancel``/``scheduler.add`` run outside it
        (``_post`` takes the same non-reentrant lock via ``_cv``)."""
        with self._lock:
            if self._bootstrapping or not self._bootstrap_nodes:
                return
            self._bootstrapping = True
            self._bootstrap_tries = 0
            # Generation token: a connect→disconnect cycle can leave
            # the old chain's scheduled job pending; without this it
            # would keep running alongside the new chain, double-
            # counting tries.
            self._bootstrap_gen += 1
            gen = self._bootstrap_gen
            job, self._bootstrap_job = self._bootstrap_job, None
        if job is not None:
            job.cancel()

        def retry():
            with self._lock:
                if (gen != self._bootstrap_gen
                        or not self._bootstrapping
                        or not self._running):
                    return
            if self.get_status() == NodeStatus.Connected:
                with self._lock:
                    self._bootstrapping = False
                return
            with self._lock:
                self._bootstrap_tries += 1
                tries = self._bootstrap_tries
            if tries > BOOTSTRAP_MAX_TRIES:
                # Give up: release the gate and wake the loop so gated
                # ops run now (they will fail fast on the empty table).
                # The give-up is permanent for this chain (deliberate
                # divergence from the reference's retry-forever), so
                # make it VISIBLE: log + fire the status callback so
                # callers know to re-bootstrap() if the network heals.
                with self._lock:
                    self._bootstrapping = False
                    s4, s6 = self._status4, self._status6
                self.log.w("bootstrap gave up after %d fruitless "
                           "rounds; call bootstrap() to retry",
                           BOOTSTRAP_MAX_TRIES)
                if self.on_status_changed:
                    self.on_status_changed(s4, s6)
                with self._cv:
                    self._cv.notify_all()
                return
            # most recently added first
            for host, port in reversed(self._bootstrap_nodes):
                for addr in self._resolve(host, port):
                    self.dht.ping_node(addr, None)
            job2 = self.scheduler.add(
                self.scheduler.time() + BOOTSTRAP_PERIOD, retry)
            with self._lock:
                self._bootstrap_job = job2

        self._post(retry, prio=True)

    @staticmethod
    def _resolve(host: str, port: int) -> List[SockAddr]:
        """DNS resolution (ref: getAddrInfo dhtrunner.cpp:679-702)."""
        try:
            infos = _socket.getaddrinfo(host, port, type=_socket.SOCK_DGRAM)
        except OSError:
            return []
        out, seen = [], set()
        for family, _, _, _, sa in infos:
            if family == _socket.AF_INET:
                a = SockAddr(sa[0], sa[1], AF_INET)
            elif family == _socket.AF_INET6:
                a = SockAddr(sa[0], sa[1], AF_INET6)
            else:
                continue
            k = (a.host, a.port, a.family)
            if k not in seen:
                seen.add(k)
                out.append(a)
        return out

    # ------------------------------------------------------------------ #
    # operations (all enqueue to the loop thread)                        #
    # ------------------------------------------------------------------ #

    def get(self, info_hash: InfoHash, get_cb: Optional[GetCallback],
            done_cb: Optional[DoneCallback] = None,
            f: Optional[Filter] = None,
            where: Optional[Where] = None) -> None:
        self._post(lambda: self.dht.get(info_hash, get_cb, done_cb, f,
                                        where))

    def get_future(self, info_hash: InfoHash,
                   f: Optional[Filter] = None) -> "Future[List[Value]]":
        fut: Future = Future()
        vals: List[Value] = []

        def gcb(vs):
            vals.extend(vs)
            return True

        def dcb(ok, nodes):
            if not fut.done():
                fut.set_result(vals)
        self.get(info_hash, gcb, dcb, f)
        return fut

    def put(self, info_hash: InfoHash, value: Value,
            done_cb: Optional[DoneCallback] = None,
            permanent: bool = False) -> None:
        self._post(lambda: self.dht.put(info_hash, value, done_cb, None,
                                        permanent))

    def put_future(self, info_hash: InfoHash, value: Value,
                   permanent: bool = False) -> "Future[bool]":
        fut: Future = Future()
        self.put(info_hash, value,
                 lambda ok, nodes: fut.done() or fut.set_result(ok),
                 permanent)
        return fut

    def put_signed(self, info_hash: InfoHash, value: Value,
                   done_cb: Optional[DoneCallback] = None,
                   permanent: bool = False) -> None:
        self._post(lambda: self.dht.put_signed(info_hash, value, done_cb,
                                               permanent))

    def put_encrypted(self, info_hash: InfoHash, to: InfoHash,
                      value: Value,
                      done_cb: Optional[DoneCallback] = None,
                      permanent: bool = False) -> None:
        self._post(lambda: self.dht.put_encrypted(info_hash, to, value,
                                                  done_cb, permanent))

    def listen(self, info_hash: InfoHash, cb: GetCallback,
               f: Optional[Filter] = None,
               where: Optional[Where] = None) -> "Future[int]":
        fut: Future = Future()
        self._post(lambda: fut.set_result(
            self.dht.listen(info_hash, cb, f, where)))
        return fut

    def cancel_listen(self, info_hash: InfoHash, token) -> None:
        def op():
            t = token.result() if isinstance(token, Future) else token
            self.dht.cancel_listen(info_hash, t)
        self._post(op)

    def cancel_put(self, info_hash: InfoHash, vid: int) -> None:
        self._post(lambda: self.dht.cancel_put(info_hash, vid))

    def find_certificate(self, h: InfoHash, cb) -> None:
        self._post(lambda: self.dht.find_certificate(h, cb))

    def find_public_key(self, h: InfoHash, cb) -> None:
        self._post(lambda: self.dht.find_public_key(h, cb))

    # ------------------------------------------------------------------ #
    # introspection (loop-thread reads; fine for diagnostics)            #
    # ------------------------------------------------------------------ #

    def get_nodes_stats(self, af: int = AF_INET):
        return self.dht.get_nodes_stats(af)

    def get_node_stats(self, af: int = AF_INET):
        """Full ``NodeStats`` snapshot (good/dubious/cached/incoming
        node counts, live searches, storage keys/values/bytes) — the
        runner-level mirror of the reference ``DhtRunner::getNodesStats``
        returning the ``NodeStats`` struct."""
        return self.dht.node_stats(af)

    def get_stats(self):
        """``(stats_in, stats_out)`` canonical per-message-type wire
        counters (see net.network_engine.CANONICAL_TYPES)."""
        return self.dht.engine.get_stats()

    @property
    def metrics(self):
        """The node's MetricsRegistry (None before :meth:`run`)."""
        return self.dht.metrics if self.dht is not None else None

    def get_public_address(self, af: int = 0):
        return self.dht.get_public_address(af)

    def export_nodes(self):
        return self.dht.export_nodes()

    def export_values(self):
        return self.dht.export_values()

    # ------------------------------------------------------------------ #
    # state persistence (checkpoint/resume; the reference leaves blob    #
    # storage to callers — ref: exportNodes/importValues                 #
    # src/dht.cpp:3029-3121)                                             #
    # ------------------------------------------------------------------ #

    def save_state(self, path: str) -> None:
        """Persist good nodes + stored values to a file."""
        from .nodeset import NodeSet
        ns = NodeSet(self.dht.export_nodes())
        blob = packb({
            "nodes": ns.serialize(),
            "values": self.dht.export_values(),
        })
        with open(path, "wb") as f:
            f.write(blob)

    def load_state(self, path: str) -> int:
        """Re-insert persisted nodes (no pings) and import values.
        Returns the number of bootstrap nodes restored."""
        from .nodeset import NodeSet
        with open(path, "rb") as f:
            obj = unpackb(f.read())
        ns = NodeSet.deserialize(obj["nodes"])
        self.bootstrap_nodes(list(ns))
        vals = [tuple(v) for v in obj.get("values", [])]
        self._post(lambda: self.dht.import_values(vals), prio=True)
        return len(ns)
