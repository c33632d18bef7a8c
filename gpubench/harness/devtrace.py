"""Reduce a ``torch.profiler`` session to what the per-layer readers and
the result line need: device busy time, kernel time and launches, the
operations that took most time, and the idle gaps named by the harness
span open on the host at the time."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float  # from the first profiled call's start to the last's end
    busy_s: float  # union of device operations inside the window
    kernel_s: float  # summed kernel durations
    kernels: int  # kernel launches
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _kind(ev) -> str:
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind()
    # older profilers: tell device work by its device and name
    if "CUDA" not in str(ev.device_type()):
        return "cpu"
    name = ev.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _span_ns(ev) -> Tuple[int, int]:
    if hasattr(ev, "start_ns"):
        a = ev.start_ns()
        return a, a + ev.duration_ns()
    a = int(ev.start_us() * 1000)
    return a, a + int(ev.duration_us() * 1000)


def summarize(prof, spans: Tuple[str, ...], top: int = 10) -> TraceSummary:
    """``spans``: the names of the harness's ``record_function`` ranges;
    the window runs from the first such range's start to the last's end."""
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        kind, name = _kind(ev), ev.name()
        if name in spans:  # the harness's ranges, also as projected on the card
            if "CUDA" not in str(ev.device_type()):
                host.append((*_span_ns(ev), name))
        elif kind in DEVICE_KINDS:
            device.append((*_span_ns(ev), kind, name))
    if not host:
        raise RuntimeError("the profiled stretch holds no harness span")
    lo = min(a for a, _, _ in host)
    hi = max(z for _, z, _ in host)
    device = [(max(a, lo), min(z, hi), k, n) for a, z, k, n in device
              if z > lo and a < hi]
    by_name: Dict[str, float] = defaultdict(float)
    kernel_ns = kernels = 0
    for a, z, kind, name in device:
        by_name[name[:120]] += (z - a) / 1e9
        if kind == "kernel":
            kernel_ns += z - a
            kernels += 1
    busy_ns, gaps, cur = 0, [], lo
    for a, z, _, _ in sorted(device):
        if a > cur:
            gaps.append((cur, a))
        if z > cur:
            busy_ns += z - max(a, cur)
            cur = z
    if hi > cur:
        gaps.append((cur, hi))
    host.sort()

    def open_span(t: int) -> str:
        name = "between"
        for a, z, n in host:
            if a > t:
                break
            if z >= t:
                name = n
        return name

    gaps.sort(key=lambda g: g[0] - g[1])
    return TraceSummary(
        window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9,
        kernel_s=kernel_ns / 1e9, kernels=kernels,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=[(open_span((a + z) // 2), (z - a) / 1e9)
                   for a, z in gaps[:top]],
    )
