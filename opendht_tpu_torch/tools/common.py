"""Shared CLI plumbing for the tools: the port's copy of the JAX
package's ``tools/common.py`` (ref: tools/tools_common.h:108-238)."""

from __future__ import annotations

import argparse
import time
from typing import Tuple

from ..utils.logger import NONE, Logger

DEFAULT_PORT = 4222  # ref: tools/tools_common.h:108


def parse_host_port(s: str, default_port: int = DEFAULT_PORT
                    ) -> Tuple[str, int]:
    if s.startswith("["):  # [v6]:port
        host, _, rest = s[1:].partition("]")
        port = int(rest[1:]) if rest.startswith(":") else default_port
        return host, port
    host, sep, port = s.rpartition(":")
    if sep and port.isdigit():
        return host, int(port)
    return s, default_port


def add_common_args(ap: argparse.ArgumentParser) -> None:
    """ref: getopt loop tools/tools_common.h:121-178."""
    ap.add_argument("-p", "--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("-b", "--bootstrap", action="append", default=[],
                    metavar="HOST[:PORT]")
    ap.add_argument("-n", "--network", type=int, default=0)
    ap.add_argument("-i", "--identity", action="store_true",
                    help="generate a crypto identity (enables signed/"
                         "encrypted ops)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--bind", default="0.0.0.0")


def start_node(args) -> "DhtRunner":
    from ..core.dht import DhtConfig
    from ..crypto.securedht import SecureDhtConfig
    from ..runtime import DhtRunner
    from ..runtime.dhtrunner import DhtRunnerConfig

    identity = None
    if args.identity:
        # Imported lazily: the optional `cryptography` dep is only
        # needed when -i asks for a signing identity — the tools (and
        # the gateway's /metrics surface) must work without it.
        from ..crypto.identity import generate_identity
        identity = generate_identity("dhtnode", key_length=2048)
    cfg = DhtRunnerConfig(SecureDhtConfig(
        DhtConfig(network=args.network), identity))
    runner = DhtRunner(logger=Logger(level=Logger.DEBUG)
                       if args.verbose else NONE)
    runner.run(port=args.port, config=cfg, bind4=args.bind)
    for b in args.bootstrap:
        host, port = parse_host_port(b)
        runner.bootstrap(host, port)
    return runner


class OpTimer:
    """Per-op wall-clock latency printing, like the reference tools'
    callbacks (ref: tools/dhtnode.cpp:209-296)."""

    def __init__(self, what: str):
        self.what = what
        self.t0 = time.monotonic()

    def done(self, ok: bool) -> None:
        dt = (time.monotonic() - self.t0) * 1000
        print(f"{self.what}: {'ok' if ok else 'failed'} ({dt:.1f} ms)")


def repl_lines(prompt: str = ">> "):
    """Line-reading REPL generator; EOF/exit/quit terminates."""
    while True:
        try:
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return
        line = line.strip()
        if line in ("exit", "quit", "q"):
            return
        if line:
            yield line
