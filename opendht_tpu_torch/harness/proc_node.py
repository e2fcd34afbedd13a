"""Subprocess DHT node driven by a MessagePack-over-stdio control
protocol.

The port's copy of the JAX package's ``harness/proc_node.py``, with the
port's own codec (:mod:`opendht_tpu_torch.utils.mpack`).  A miniature of the reference harness's ``DhtNetworkSubProcess``
(ref: python/tools/dht/network.py:42-280,447-595): the parent spawns
``python -m opendht_tpu_torch.harness.proc_node``, writes MessagePack request
maps to its stdin and reads MessagePack reply maps from its stdout, while
the node itself talks real UDP on localhost.  This is what puts an OS
process boundary (separate interpreter, separate GIL, real sockets)
under the runtime tests — the reference gets the same from netns
subprocesses.

Requests (maps with ``op``; each gets one reply map with ``ok``):

=============  ============================  ==========================
op             request fields                reply fields
=============  ============================  ==========================
run            port (0 = ephemeral)          port (bound), id (hex)
bootstrap      host, port                    —
put            key (20 B), value (bytes)     stored (bool)
get            key (20 B)                    values (list of bytes)
listen         key (20 B)                    token (int)
poll_listen    token (int)                   values (list of bytes)
stats          —                             good, dubious
shutdown       —                             — (process exits after)
=============  ============================  ==========================
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

from ..core.value import Value
from ..runtime.dhtrunner import DhtRunner
from ..utils.infohash import InfoHash
from ..utils.mpack import Unpacker, packb

# The checkout's root: the child runs from there so ``-m`` finds the
# package wherever the parent runs.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def serve(stdin=None, stdout=None) -> None:  # pragma: no cover (subproc)
    stdin = stdin or sys.stdin.buffer
    stdout = stdout or sys.stdout.buffer
    # Feed the unpacker from incremental reads: wrapping the pipe in
    # Unpacker(stream) would block in a full buffered read() until EOF.
    unpacker = Unpacker()
    fd = stdin.fileno()
    runner = DhtRunner()
    listens: Dict[int, List[bytes]] = {}
    next_token = [1]

    rid_box = [None]

    def reply(**kw):
        # Echo the request id so a parent that timed out on one request
        # can discard its late reply instead of mis-pairing the stream.
        kw["rid"] = rid_box[0]
        stdout.write(packb(kw))
        stdout.flush()

    def requests():
        while True:
            chunk = os.read(fd, 65536)
            if not chunk:
                return
            unpacker.feed(chunk)
            yield from unpacker

    for req in requests():
        op = req.get("op")
        rid_box[0] = req.get("rid")
        try:
            if op == "run":
                runner.run(port=int(req.get("port", 0)),
                           bind4="127.0.0.1")
                reply(ok=True, port=runner.get_bound_port(),
                      id=str(runner.get_id()))
            elif op == "bootstrap":
                runner.bootstrap(req["host"], int(req["port"]))
                reply(ok=True)
            elif op == "put":
                h = InfoHash(req["key"])
                fut = runner.put_future(h, Value(req["value"]))
                reply(ok=True, stored=bool(fut.result(timeout=20)))
            elif op == "get":
                h = InfoHash(req["key"])
                vals = runner.get_future(h).result(timeout=20)
                reply(ok=True, values=[v.data for v in vals])
            elif op == "listen":
                h = InfoHash(req["key"])
                token = next_token[0]
                next_token[0] += 1
                box: List[bytes] = []
                listens[token] = box

                def on_values(vs, box=box):
                    box.extend(v.data for v in vs)
                    return True
                runner.listen(h, on_values)
                reply(ok=True, token=token)
            elif op == "poll_listen":
                box = listens.get(int(req["token"]), [])
                vals, box[:] = list(box), []
                reply(ok=True, values=vals)
            elif op == "stats":
                st = runner.get_nodes_stats()
                reply(ok=True, good=int(st[0]), dubious=int(st[1]))
            elif op == "shutdown":
                runner.shutdown()
                runner.join()
                reply(ok=True)
                return
            else:
                reply(ok=False, error=f"unknown op {op!r}")
        except Exception as e:  # noqa: BLE001 — report to the parent
            reply(ok=False, error=f"{type(e).__name__}: {e}")


class ProcNode:
    """Parent-side handle: spawn, drive, and stop a subprocess node."""

    def __init__(self):
        import subprocess

        self.proc = subprocess.Popen(
            [sys.executable, "-m", "opendht_tpu_torch.harness.proc_node"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, cwd=_ROOT)
        self._unpacker = Unpacker()
        self._next_rid = 0

    def request(self, timeout: float = 30.0, **req) -> dict:
        """Send one request, return its reply.

        Requests carry a monotonically increasing ``rid`` echoed in the
        reply; a reply arriving late for an earlier (timed-out) request
        is discarded rather than mis-paired with the current one.
        """
        self._next_rid += 1
        rid = self._next_rid
        req["rid"] = rid
        self.proc.stdin.write(packb(req))
        self.proc.stdin.flush()
        end = time.monotonic() + timeout
        import select
        fd = self.proc.stdout.fileno()
        while time.monotonic() < end:
            r, _, _ = select.select([fd], [], [], 0.1)
            if r:
                chunk = os.read(fd, 65536)
                if not chunk:
                    break
                self._unpacker.feed(chunk)
                for msg in self._unpacker:
                    if msg.get("rid") == rid:
                        return msg
                    # stale reply to a timed-out request: drop it
        raise TimeoutError(f"no reply to {req.get('op')!r}")

    def close(self) -> None:
        try:
            if self.proc.poll() is None:
                self.request(op="shutdown", timeout=10)
        except Exception:
            pass
        finally:
            try:
                self.proc.stdin.close()
            except Exception:
                pass
            try:
                self.proc.wait(timeout=10)
            except Exception:
                self.proc.kill()
                self.proc.wait(timeout=5)


class ProcCluster:
    """A cluster of subprocess nodes — the multi-process half of the
    harness (ref ``DhtNetwork`` managing ``DhtNetworkSubProcess``
    clusters, python/tools/dht/network.py:283-445).

    Each node is its own OS process with real UDP sockets on
    localhost, star-bootstrapped to node 0.
    """

    def __init__(self, n: int):
        # Build incrementally so a spawn failure partway still closes
        # the processes already started.
        self.nodes: List[ProcNode] = []
        self.ports: List[int] = []
        try:
            for _ in range(n):
                self.nodes.append(ProcNode())
            for node in self.nodes:
                r = node.request(op="run", port=0)
                if not r.get("ok"):
                    raise RuntimeError(f"run failed: {r}")
                self.ports.append(r["port"])
            for i, node in enumerate(self.nodes):
                peer = self.ports[0] if i else self.ports[-1]
                r = node.request(op="bootstrap", host="127.0.0.1",
                                 port=peer)
                if not r.get("ok"):
                    raise RuntimeError(f"bootstrap failed: {r}")
        except Exception:
            self.close()
            raise

    def wait_connected(self, min_good: int = 1,
                       timeout: float = 60.0) -> bool:
        """Every node sees ≥ min_good good peers.

        A child process that died (or stopped answering) counts as
        not-connected rather than raising an opaque TimeoutError out
        of the poll loop — the caller sees a clean False.
        """
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            stats = []
            for n in self.nodes:
                if n.proc.poll() is not None:
                    stats.append({"good": -1, "dead": True})
                    continue
                try:
                    stats.append(n.request(op="stats", timeout=5))
                except (TimeoutError, OSError):
                    stats.append({"good": -1})
            if all(s.get("good", 0) >= min_good for s in stats):
                return True
            time.sleep(0.2)
        return False

    def put(self, i: int, key: bytes, value: bytes) -> bool:
        r = self.nodes[i].request(op="put", key=key, value=value)
        return bool(r.get("ok") and r.get("stored"))

    def get(self, i: int, key: bytes) -> List[bytes]:
        r = self.nodes[i].request(op="get", key=key)
        return list(r.get("values", []))

    def stats(self) -> List[dict]:
        """Per-node stats; a dead/unresponsive child reports an error
        entry instead of blowing up the whole sweep."""
        out = []
        for n in self.nodes:
            if n.proc.poll() is not None:
                out.append({"error": "process exited",
                            "returncode": n.proc.returncode})
                continue
            try:
                out.append(n.request(op="stats", timeout=5))
            except (TimeoutError, OSError) as e:
                out.append({"error": f"{type(e).__name__}: {e}"})
        return out

    def close(self) -> None:
        for n in self.nodes:
            n.close()


if __name__ == "__main__":
    serve()
