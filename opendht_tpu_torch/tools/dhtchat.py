"""dhtchat: chat rooms over the DHT (ref: tools/dhtchat.cpp); the port's
copy of the JAX package's ``tools/dhtchat.py``.

A room is a key; messages are ``ImMessage`` values put (signed when an
identity is present) at the room hash and received via ``listen``
(ref: tools/dhtchat.cpp:97-127).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..core.default_types import ImMessage
from ..core.value import Value
from ..utils.infohash import InfoHash
from .common import add_common_args, repl_lines, start_node


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dhtchat", description=__doc__)
    add_common_args(ap)
    ap.add_argument("room", nargs="?", default="lobby")
    args = ap.parse_args(argv)
    node = start_node(args)
    room = InfoHash.get(f"dhtchat-room-{args.room}")
    start = int(time.time())
    print(f"Joined room '{args.room}' ({room}) as {node.get_node_id()}")

    def on_msgs(vals) -> bool:
        for v in vals:
            if v.type != ImMessage.TYPE.id:
                continue
            try:
                m = ImMessage.unpack(v.data)
            except Exception:
                continue
            if m.date >= start:
                who = (str(v.owner.get_id())[:8]
                       if v.owner is not None else "anon")
                print(f"\r<{who}> {m.message}")
        return True

    node.listen(room, on_msgs)

    for line in repl_lines("me> "):
        msg = ImMessage(0, line, int(time.time()))
        v = Value(msg.pack(), ImMessage.TYPE.id)
        if node.get_id() is not None:
            node.put_signed(room, v)
        else:
            node.put(room, v)

    node.shutdown()
    node.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
