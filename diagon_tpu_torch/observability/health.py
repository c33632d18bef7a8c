"""Health checks (reference ``observability/HealthCheck.h:19-102``): the
port's copy of ``diagon_tpu/observability/health.py``, with the device
probe on ``torch.cuda`` in place of the JAX backend probe."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Dict, List


class HealthStatus(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    UNHEALTHY = "unhealthy"


@dataclass
class HealthCheckResult:
    name: str
    status: HealthStatus
    message: str = ""
    critical: bool = True


@dataclass
class HealthCheck:
    name: str
    check: Callable[[], HealthCheckResult]
    critical: bool = True


class HealthRegistry:
    def __init__(self):
        self._checks: Dict[str, HealthCheck] = {}

    def register(self, name: str, check: Callable[[], HealthCheckResult],
                 critical: bool = True) -> None:
        self._checks[name] = HealthCheck(name, check, critical)

    def run_all(self) -> List[HealthCheckResult]:
        results = []
        for hc in self._checks.values():
            try:
                r = hc.check()
            except Exception as e:  # noqa: BLE001 - report, don't crash
                r = HealthCheckResult(
                    hc.name, HealthStatus.UNHEALTHY, str(e), hc.critical
                )
            r.critical = hc.critical
            results.append(r)
        return results

    def overall(self) -> HealthStatus:
        """UNHEALTHY if any critical check fails; DEGRADED if any
        non-critical fails (reference critical/non-critical semantics)."""
        status = HealthStatus.HEALTHY
        for r in self.run_all():
            if r.status != HealthStatus.HEALTHY:
                if r.critical:
                    return HealthStatus.UNHEALTHY
                status = HealthStatus.DEGRADED
        return status


def device_health_check(device="cuda") -> HealthCheckResult:
    """Liveness of the device the port serves on (its critical
    dependency). For a CUDA ``device``: HEALTHY with the device count and
    the card's name, UNHEALTHY when CUDA is not available or the named
    card is not there; never HEALTHY on the CPU in its place. A CPU
    ``device`` is HEALTHY (the plain versions serve there)."""
    try:
        import torch

        dev = torch.device(device)
        if dev.type != "cuda":
            return HealthCheckResult(
                "torch_device", HealthStatus.HEALTHY, f"device={dev}"
            )
        if not torch.cuda.is_available():
            return HealthCheckResult(
                "torch_device",
                HealthStatus.UNHEALTHY,
                f"device={dev} asked for, but CUDA is not available",
            )
        n = torch.cuda.device_count()
        index = dev.index if dev.index is not None else 0
        if index >= n:
            return HealthCheckResult(
                "torch_device",
                HealthStatus.UNHEALTHY,
                f"device={dev} asked for, {n} CUDA device(s)",
            )
        return HealthCheckResult(
            "torch_device",
            HealthStatus.HEALTHY,
            f"{n} device(s), {torch.cuda.get_device_name(index)}",
        )
    except Exception as e:  # noqa: BLE001 - report, don't crash
        return HealthCheckResult("torch_device", HealthStatus.UNHEALTHY, str(e))
