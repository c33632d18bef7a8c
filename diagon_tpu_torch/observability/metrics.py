"""In-process metrics (reference ``observability/Metrics.h:43-265``): the
port's own copy of ``diagon_tpu/observability/metrics.py``, with its own
process-wide ``registry`` (the row engine's routing and escalation
counters live there under the JAX package's names)."""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional


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


class Gauge:
    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._value += v

    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with percentile estimation."""

    DEFAULT_BUCKETS = [
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0,
    ]

    def __init__(self, name: str, description: str = "",
                 buckets: Optional[List[float]] = None):
        self.name = name
        self.description = description
        self.buckets = sorted(buckets or self.DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    def count(self) -> int:
        return self._n

    def sum(self) -> float:
        return self._sum

    def mean(self) -> float:
        return self._sum / self._n if self._n else 0.0

    def percentile(self, p: float) -> float:
        """Bucket-upper-bound estimate of the p-quantile (p in [0,1])."""
        with self._lock:
            if self._n == 0:
                return 0.0
            target = p * self._n
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= target:
                    return (
                        self.buckets[i]
                        if i < len(self.buckets)
                        else float("inf")
                    )
            return float("inf")


class Timer(Histogram):
    """Histogram in seconds with a convenience context manager."""

    def time(self) -> "ScopedTimer":
        return ScopedTimer(self)


class ScopedTimer:
    def __init__(self, timer: Timer):
        self.timer = timer
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.observe(time.perf_counter() - self._t0)


class MetricsRegistry:
    """Process-wide named metrics (reference MetricsRegistry)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, description: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, description), Counter)

    def gauge(self, name: str, description: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, description), Gauge)

    def histogram(self, name: str, description: str = "") -> Histogram:
        return self._get(name, lambda: Histogram(name, description), Histogram)

    def timer(self, name: str, description: str = "") -> Timer:
        return self._get(name, lambda: Timer(name, description), Timer)

    def _get(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out = {}
            for name, m in self._metrics.items():
                if isinstance(m, Counter):
                    out[name] = m.value()
                elif isinstance(m, Gauge):
                    out[name] = m.value()
                elif isinstance(m, Histogram):
                    out[name] = {
                        "count": m.count(),
                        "sum": m.sum(),
                        "mean": m.mean(),
                        "p50": m.percentile(0.50),
                        "p99": m.percentile(0.99),
                    }
            return out


registry = MetricsRegistry()
