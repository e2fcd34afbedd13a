"""Test/benchmark harness: in-process cluster manager + scenario suite."""

from .network import DhtNetwork  # noqa: F401
from .scenarios import SCENARIOS  # noqa: F401
