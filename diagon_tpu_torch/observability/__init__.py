"""Observability: metrics registry, health checks, query profiling, and the
storage tiers -- the port's counterpart of ``diagon_tpu/observability``.

Equivalent of the reference's aux subsystems (SURVEY.md section 5:
``observability/Metrics.h`` Counter/Gauge/Histogram/Timer + process-wide
registry; ``HealthCheck.h`` critical/non-critical checks;
``util/QueryProfiler.h`` phase timers with name -> {total,count,min,max}).
"""

from diagon_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    ScopedTimer,
    Timer,
    registry,
)
from diagon_tpu_torch.observability.health import (  # noqa: F401
    HealthCheck,
    HealthCheckResult,
    HealthRegistry,
    HealthStatus,
)
from diagon_tpu_torch.observability.profiler import (  # noqa: F401
    ProfileScope,
    QueryProfiler,
)
