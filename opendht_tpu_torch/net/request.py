"""Outbound RPC request lifecycle.

Re-design of the reference ``net::Request`` (ref: include/opendht/request.h:
60-137): a request is PENDING until a reply (COMPLETED), an error/cancel
(CANCELLED), or 3 unanswered attempts 1 s apart (EXPIRED) — retransmits are
scheduler jobs, never blocking (ref: requestStep
src/network_engine.cpp:232-262).
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

from ..core.constants import MAX_ATTEMPT_COUNT


class RequestState(enum.Enum):
    PENDING = 0
    CANCELLED = 1
    EXPIRED = 2
    COMPLETED = 3


class Request:
    __slots__ = ("tid", "node", "msg", "on_done", "on_expired", "attempt_count",
                 "start", "last_try", "reply_time", "state", "_job",
                 "__weakref__")

    def __init__(self, tid: int, node, msg: bytes,
                 on_done: Optional[Callable] = None,
                 on_expired: Optional[Callable] = None):
        self.tid = tid
        self.node = node
        self.msg = msg
        self.on_done = on_done      # (request, answer) -> None
        self.on_expired = on_expired  # (request, over) -> None
        self.attempt_count = 0
        self.start = 0.0
        self.last_try = 0.0
        self.reply_time = 0.0
        self.state = RequestState.PENDING
        self._job = None            # retransmit scheduler job

    def pending(self) -> bool:
        return self.state == RequestState.PENDING

    def completed(self) -> bool:
        return self.state == RequestState.COMPLETED

    def expired(self) -> bool:
        return self.state == RequestState.EXPIRED

    def cancel(self) -> None:
        if self.pending():
            self.state = RequestState.CANCELLED
            self._cancel_job()

    def set_done(self, now: float) -> None:
        self.reply_time = now
        self.state = RequestState.COMPLETED
        self._cancel_job()

    def set_expired(self) -> None:
        if self.pending():
            self.state = RequestState.EXPIRED
            self._cancel_job()
            if self.node is not None:
                self.node.request_expired(self)
            if self.on_expired:
                self.on_expired(self, True)

    def over_attempts(self) -> bool:
        return self.attempt_count >= MAX_ATTEMPT_COUNT

    def _cancel_job(self) -> None:
        if self._job is not None:
            self._job.cancel()
            self._job = None
