"""Logging with per-InfoHash filtering.

Re-design of the reference logger (ref: include/opendht/log_enable.h:43-173,
src/log.cpp:29-84): three levels (debug/warn/error), optional filter that
restricts output to messages mentioning one InfoHash — invaluable when
debugging a single key's traffic in a large swarm.
"""

from __future__ import annotations

import sys
import time
from typing import Optional


class Logger:
    __slots__ = ("name", "level", "_filter", "stream", "enabled")

    DEBUG, WARN, ERROR, OFF = 0, 1, 2, 3

    def __init__(self, name: str = "dht", level: int = OFF, stream=None):
        self.name = name
        self.level = level
        self._filter = None
        self.stream = stream or sys.stderr
        self.enabled = level < Logger.OFF

    def set_filter(self, h: Optional[object],
                   prefix_len: int = 8) -> None:
        """Only emit messages that mention hash ``h``
        (ref: log_enable.h:126-173).

        Matching is by the hash's first ``prefix_len`` hex chars: log
        call sites abbreviate hashes differently (full 40-hex, 8-hex
        short ids, ...), so the filter compares a configurable prefix —
        longer prefixes cut false positives in big swarms, shorter ones
        catch heavily-truncated log forms.  ``prefix_len <= 0`` or a
        prefix longer than the hash string falls back to the full
        string.
        """
        if h:
            s = str(h)
            self._filter = s[:prefix_len] if prefix_len > 0 else s
        else:
            self._filter = None

    def _log(self, lvl_name: str, fmt: str, *args) -> None:
        msg = (fmt % args) if args else fmt
        if self._filter is not None and self._filter not in msg:
            return
        t = time.time()
        ts = time.strftime("%H:%M:%S", time.localtime(t))
        us = int((t % 1) * 1e6)
        print(f"[{ts}.{us:06d}] [{self.name}] {lvl_name}: {msg}",
              file=self.stream)

    def d(self, fmt: str, *args) -> None:
        if self.level <= Logger.DEBUG and self.enabled:
            self._log("DBG", fmt, *args)

    def w(self, fmt: str, *args) -> None:
        if self.level <= Logger.WARN and self.enabled:
            self._log("WRN", fmt, *args)

    def e(self, fmt: str, *args) -> None:
        if self.level <= Logger.ERROR and self.enabled:
            self._log("ERR", fmt, *args)


NONE = Logger(level=Logger.OFF)
