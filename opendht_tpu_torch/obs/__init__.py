"""Observability of the port: the cost ledger (kernel, memory and phase
planes), the Prometheus planes over the metrics registry (latency, swarm
health, soak, resident), hop-model fidelity, keyspace density, and the
sweep, soak and resident-loop summaries.

:mod:`~opendht_tpu_torch.obs.ledger` writes the JAX package's
``cost_ledger`` artifact, which ``tools/check_trace.py`` and
``tools/roofline.py`` read unchanged (the port's own copies and JAX's).
"""

from .health import (  # noqa: F401
    SwarmHealthPlane,
    analytic_hop_pmf,
    hop_fidelity,
    poisson_density_profile,
)
from .latency import (  # noqa: F401
    LatencyPlane,
    publish_hop_histogram,
)
from .ledger import (  # noqa: F401
    CostLedger,
    hbm_watermark,
    instrumented_entry_points,
    measure_round_phases,
    step_cache_size,
)
from .timeline import (  # noqa: F401
    ResidentPlane,
    SoakPlane,
)
