"""dhtnode: interactive DHT REPL (ref: tools/dhtnode.cpp); the port's
copy of the JAX package's ``tools/dhtnode.py``.

Commands (parity with the reference REPL, tools/dhtnode.cpp:96-140):

  h                  help
  ll                 node info + stats
  ls                 searches log
  ld                 storage log
  lr                 routing table log
  stats              node-stats table + wire message counters
  dump               full dump: routing tables + searches + storage
  b <host[:port]>    bootstrap
  g <key>            get
  p <key> <data>     put
  s <key> <data>     put signed
  e <key> <to> <dat> put encrypted for <to> (key id)
  l <key>            listen
  cl <key> <token>   cancel listen
  ii <name> <k> <v>  index insert (PHT)
  il <name> <k>      index lookup (PHT)
  q                  quit
"""

from __future__ import annotations

import argparse
import sys

from ..core.value import Value
from ..indexation.pht import Pht
from ..utils.infohash import InfoHash
from ..utils.sockaddr import AF_INET, AF_INET6
from .common import (OpTimer, add_common_args, parse_host_port,
                     repl_lines, start_node)


def _h(word: str) -> InfoHash:
    return InfoHash(word) if len(word) == 40 else InfoHash.get(word)


def format_stats(node) -> str:
    """Node-stats table + wire counters (the reference ``dhtnode``'s
    ``ll`` info block, tabulated)."""
    rows = [("", "good", "dubious", "cached", "incoming", "searches")]
    for af, name in ((AF_INET, "IPv4"), (AF_INET6, "IPv6")):
        ns = node.get_node_stats(af)
        rows.append((name, ns.good_nodes, ns.dubious_nodes,
                     ns.cached_nodes, ns.incoming_nodes, ns.searches))
    widths = [max(len(str(r[c])) for r in rows)
              for c in range(len(rows[0]))]
    out = [f"Node {node.get_node_id()}"]
    for r in rows:
        out.append("  " + "  ".join(
            str(v).rjust(w) for v, w in zip(r, widths)))
    ns = node.get_node_stats(AF_INET)
    out.append(f"  storage: {ns.storage_values} values, "
               f"{ns.storage_bytes} B in {ns.storage_keys} keys")
    stats_in, stats_out = node.get_stats()
    keys = sorted(set(stats_in) | set(stats_out))
    out.append("  messages (in/out): " + ", ".join(
        f"{k} {stats_in.get(k, 0)}/{stats_out.get(k, 0)}" for k in keys))
    return "\n".join(out)


def format_dump(node) -> str:
    """Routing tables + searches + storage — the reference ``ll``+``ld``
    dumps in one command."""
    parts = []
    for af, name in ((AF_INET, "IPv4"), (AF_INET6, "IPv6")):
        log = node.dht.get_routing_table_log(af)
        if log:
            parts.append(f"--- routing table {name} ---\n{log}")
    searches = node.dht.get_searches_log()
    if searches:
        parts.append(f"--- searches ---\n{searches}")
    parts.append(f"--- storage ---\n{node.dht.get_storage_log()}")
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dhtnode", description=__doc__)
    add_common_args(ap)
    args = ap.parse_args(argv)
    node = start_node(args)
    print(f"OpenDHT node {node.get_node_id()} "
          f"on port {node.get_bound_port()}")

    indexes = {}
    listen_tokens = {}

    def get_index(name: str) -> Pht:
        if name not in indexes:
            indexes[name] = Pht(name, {"id": 16}, node.dht)
        return indexes[name]

    for line in repl_lines():
        try:
            parts = line.split()
            op, rest = parts[0], parts[1:]
            if op == "h":
                print(__doc__)
            elif op == "ll":
                good, dubious, cached, incoming = node.get_nodes_stats(
                    AF_INET)
                print(f"Node {node.get_node_id()} — IPv4: {good} good, "
                      f"{dubious} dubious, {cached} cached, "
                      f"{incoming} incoming")
                for a in node.get_public_address():
                    print(f"  public address: {a.host}:{a.port}")
            elif op == "ls":
                print(node.dht.get_searches_log())
            elif op == "ld":
                print(node.dht.get_storage_log())
            elif op == "lr":
                print(node.dht.get_routing_table_log(AF_INET))
            elif op == "stats":
                print(format_stats(node))
            elif op == "dump":
                print(format_dump(node))
            elif op == "b":
                host, port = parse_host_port(rest[0])
                node.bootstrap(host, port)
            elif op == "g":
                t = OpTimer(f"get {rest[0]}")
                node.get(_h(rest[0]),
                         lambda vals: [print(f"  value: {v}")
                                       for v in vals] or True,
                         lambda ok, nodes: t.done(ok))
            elif op == "p":
                t = OpTimer(f"put {rest[0]}")
                node.put(_h(rest[0]), Value(" ".join(rest[1:]).encode()),
                         lambda ok, nodes: t.done(ok))
            elif op == "s":
                t = OpTimer(f"putSigned {rest[0]}")
                node.put_signed(_h(rest[0]),
                                Value(" ".join(rest[1:]).encode()),
                                lambda ok, nodes: t.done(ok))
            elif op == "e":
                t = OpTimer(f"putEncrypted {rest[0]}")
                node.put_encrypted(_h(rest[0]), InfoHash(rest[1]),
                                   Value(" ".join(rest[2:]).encode()),
                                   lambda ok, nodes: t.done(ok))
            elif op == "l":
                h = _h(rest[0])
                tok = node.listen(
                    h, lambda vals: [print(f"  [listen] {v}")
                                     for v in vals] or True)
                listen_tokens[rest[0]] = tok
                print(f"listening on {h} (token {rest[0]})")
            elif op == "cl":
                tok = listen_tokens.pop(rest[0], None)
                if tok is not None:
                    node.cancel_listen(_h(rest[0]), tok)
            elif op == "ii":
                t = OpTimer(f"index insert {rest[1]}")
                get_index(rest[0]).insert(
                    {"id": rest[1].encode()[:16]},
                    (_h(rest[2] if len(rest) > 2 else rest[1]), 1),
                    t.done)
            elif op == "il":
                t = OpTimer(f"index lookup {rest[1]}")
                get_index(rest[0]).lookup(
                    {"id": rest[1].encode()[:16]},
                    lambda vals, p: [print(f"  entry: {h} {vid}")
                                     for h, vid in vals],
                    t.done)
            else:
                print(f"unknown command: {op} (h for help)")
        except (IndexError, ValueError) as e:
            print(f"error: {e}")

    print("Stopping node...")
    node.shutdown()
    node.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
