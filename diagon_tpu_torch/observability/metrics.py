"""In-process counters (reference ``observability/Metrics.h:43-265``): the
part of ``diagon_tpu/observability/metrics.py`` the port uses, with the
port's own process-wide ``registry``. The port counts only (the row
engine's routing and escalation counters, under the JAX package's names).
"""

from __future__ import annotations

import threading
from typing import Dict


class Counter:
    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._value = 0
        self._lock = threading.Lock()

    def increment(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def value(self) -> int:
        return self._value


class MetricsRegistry:
    """Process-wide named counters (reference MetricsRegistry)."""

    def __init__(self):
        self._metrics: Dict[str, Counter] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, description: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, description)
            return m

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {name: m.value() for name, m in self._metrics.items()}


registry = MetricsRegistry()
