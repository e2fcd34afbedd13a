"""Scenario tests over the virtual cluster — the reference's
FeatureTest/PersistenceTest/PerformanceTest suite re-done in-process
(ref: python/tools/dht/tests.py:181-994).

Each scenario returns a metrics dict; the benchmark CLI prints them.
Virtual time makes minutes-long churn scenarios run in wall-clock
milliseconds.
"""

from __future__ import annotations

import random
import statistics
from typing import Dict, List

from ..core.value import Value
from ..utils.infohash import InfoHash
from .network import DhtNetwork


def _put(net: DhtNetwork, node, h: InfoHash, data: bytes,
         timeout: float = 30.0) -> bool:
    done = {}
    node.put(h, Value(data), lambda ok, nodes: done.update(ok=ok))
    net.run_until(lambda: "ok" in done, timeout)
    return done.get("ok", False)


def _get(net: DhtNetwork, node, h: InfoHash, timeout: float = 30.0):
    got: List[Value] = []
    done = {}
    node.get(h, lambda vals: got.extend(vals) or True,
             lambda ok, nodes: done.update(ok=ok))
    net.run_until(lambda: "ok" in done, timeout)
    return got, done.get("ok", False)


def performance_gets(n_nodes: int = 32, rounds: int = 10,
                     gets_per_round: int = 50, seed: int = 1,
                     delay: float = 0.01, loss: float = 0.0
                     ) -> Dict[str, float]:
    """Random-key get latency distribution over a churning cluster
    (ref: PerformanceTest 'gets' tests.py:865-950)."""
    net = DhtNetwork(n_nodes, seed=seed, delay=delay, loss=loss)
    net.bootstrap_all()
    net.warmup()
    rng = random.Random(seed)
    times: List[float] = []
    for r in range(rounds):
        net.replace_cluster(max(1, n_nodes // 8))
        net.run(2.0)
        for _ in range(gets_per_round):
            node = rng.choice(net.nodes)
            h = InfoHash.get_random()
            t0 = net.clock.now()
            _get(net, node, h)
            times.append(net.clock.now() - t0)
    return {
        "gets": len(times),
        "sum_s": round(sum(times), 3),
        "mean_s": round(statistics.mean(times), 4),
        "stdev_s": round(statistics.pstdev(times), 4),
        "min_s": round(min(times), 4),
        "max_s": round(max(times), 4),
    }


def persistence_delete(n_nodes: int = 24, n_values: int = 8,
                       seed: int = 2) -> Dict[str, float]:
    """Put values, kill every node currently storing them, verify the
    values are re-found on fresh nodes (ref: PersistenceTest 'delete'
    tests.py:439-550)."""
    net = DhtNetwork(n_nodes, seed=seed)
    net.bootstrap_all()
    net.warmup()
    writer = net.nodes[1]
    keys = [InfoHash.get(f"persist-{i}") for i in range(n_values)]
    stored = 0
    for i, h in enumerate(keys):
        if _put(net, writer, h, f"value-{i}".encode()):
            stored += 1
    net.run(5.0)

    # Kill every storing node (the writer keeps its local replica alive
    # and must republish — ref maintain_storage / dataPersistence).
    killed = 0
    for d in list(net.nodes):
        if d is writer:
            continue
        if any(d.get_local(h) for h in keys):
            net.remove_node(d)
            killed += 1
    # Fresh nodes join; give maintenance time to republish.
    for _ in range(killed):
        d = net.add_node()
        d.insert_node(net.nodes[0].myid, net.addr_of(net.nodes[0]))
    net.run(120.0)

    refound = 0
    reader = net.nodes[-1]
    for h in keys:
        got, _ = _get(net, reader, h)
        if got:
            refound += 1
    return {"stored": stored, "killed_hosts": killed,
            "refound": refound, "total": n_values}


def persistence_replace(n_nodes: int = 24, seed: int = 3
                        ) -> Dict[str, float]:
    """Replace whole sub-clusters repeatedly and verify a value
    survives (ref: PersistenceTest 'replace' tests.py:560-640)."""
    net = DhtNetwork(n_nodes, seed=seed)
    net.bootstrap_all()
    net.warmup()
    h = InfoHash.get("survivor")
    assert _put(net, net.nodes[1], h, b"still-here")
    survived = 0
    rounds = 4
    for r in range(rounds):
        net.replace_cluster(n_nodes // 4)
        net.run(60.0)
        got, _ = _get(net, net.nodes[-1], h)
        if any(v.data == b"still-here" for v in got):
            survived += 1
    return {"rounds": rounds, "survived": survived}


def listen_churn(n_nodes: int = 16, seed: int = 4) -> Dict[str, float]:
    """Listeners keep receiving across storing-node churn
    (ref: pingpong.py + PersistenceTest mult_time)."""
    net = DhtNetwork(n_nodes, seed=seed)
    net.bootstrap_all()
    net.warmup()
    h = InfoHash.get("feed")
    seen: List[bytes] = []
    net.nodes[2].listen(h, lambda vals: seen.extend(
        v.data for v in vals) or True)
    net.run(2.0)
    sent = 0
    for i in range(5):
        if _put(net, net.nodes[3], h, f"msg-{i}".encode()):
            sent += 1
        if i == 2:
            net.replace_cluster(n_nodes // 4)
            net.run(30.0)
        net.run(5.0)
    return {"sent": sent, "received": len(set(seen))}


def local_putget(n_keys: int = 1000, seed: int = 5) -> Dict[str, float]:
    """Single-node 1k-key put/get loop — BASELINE.json config 1 (the
    CPU floor: pure core + storage path, no network)."""
    import time as _t
    net = DhtNetwork(1, seed=seed)
    node = net.nodes[0]
    keys = [InfoHash.get(f"k{i}") for i in range(n_keys)]
    t0 = _t.monotonic()
    for i, h in enumerate(keys):
        done = {}
        node.put(h, Value(f"v{i}".encode()),
                 lambda ok, nodes: done.update(ok=True))
        net.run(0.01)
    put_dt = _t.monotonic() - t0
    t0 = _t.monotonic()
    hits = 0
    for i, h in enumerate(keys):
        vals = node.get_local(h)
        if vals and vals[0].data == f"v{i}".encode():
            hits += 1
    get_dt = _t.monotonic() - t0
    return {
        "keys": n_keys, "hit_rate": hits / n_keys,
        "puts_per_sec": round(n_keys / put_dt, 1),
        "local_gets_per_sec": round(n_keys / get_dt, 1),
    }


SCENARIOS = {
    "gets": performance_gets,
    "delete": persistence_delete,
    "replace": persistence_replace,
    "listen": listen_churn,
    "local": local_putget,
}
