"""Query profiler (reference ``util/QueryProfiler.h:16-50`` +
``SearchProfiler.h`` RAII ProfileScope): the port's copy of
``diagon_tpu/observability/profiler.py``.

Thread-local phase timers: name -> {total, count, min, max} nanoseconds.
Enabled explicitly (the reference gates on -DDIAGON_PROFILING; this gates
at run time). A phase entered while a phase of the same name is open on
the thread is part of the outer one: only the outermost is timed and
counted. Device traces come from ``torch.profiler``:
``QueryProfiler.trace(dir)`` wraps a block in a profiler session and writes
a Chrome trace into ``dir``. While any ``torch.profiler`` session records,
each ``ProfileScope`` also opens a profiler range of its name, so the
phases lie on the clock of the kernels, copies and idle gaps.

A scope costs one test of two module-level flags while no profiler of
this module was ever enabled in the process and ``torch.profiler``
records nothing: ``ProfileScope(name)`` then returns a shared scope that
does nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict

from torch.autograd import profiler as _torch_profiler

try:  # the cheapest range torch offers, where it has it
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # pragma: no cover - older torch
    _Range = _torch_profiler.record_function

# set once a QueryProfiler is enabled in this process, never cleared: a
# scope looks up the thread's profiler only after that
_phases_on = False


@dataclass
class PhaseStats:
    total_ns: int = 0
    count: int = 0
    min_ns: int = 2**63 - 1
    max_ns: int = 0

    def record(self, ns: int) -> None:
        self.total_ns += ns
        self.count += 1
        self.min_ns = min(self.min_ns, ns)
        self.max_ns = max(self.max_ns, ns)


class QueryProfiler:
    _tls = threading.local()

    def __init__(self, enabled: bool = True):
        global _phases_on
        self.enabled = enabled
        self.phases: Dict[str, PhaseStats] = {}
        self._starts: Dict[str, int] = {}
        self._nested: Dict[str, int] = {}  # re-entries of an open phase
        if enabled:
            _phases_on = True

    @classmethod
    def current(cls) -> "QueryProfiler":
        p = getattr(cls._tls, "profiler", None)
        if p is None:
            p = QueryProfiler(enabled=False)
            cls._tls.profiler = p
        return p

    @classmethod
    def enable(cls) -> "QueryProfiler":
        p = QueryProfiler(enabled=True)
        cls._tls.profiler = p
        return p

    def begin_phase(self, name: str) -> None:
        if not self.enabled:
            return
        if name in self._starts:
            self._nested[name] = self._nested.get(name, 0) + 1
            return
        self._starts[name] = time.perf_counter_ns()

    def end_phase(self, name: str) -> None:
        if not self.enabled:
            return
        inner = self._nested.get(name)
        if inner:
            self._nested[name] = inner - 1
            return
        t0 = self._starts.pop(name, None)
        if t0 is None:
            return
        self.phases.setdefault(name, PhaseStats()).record(
            time.perf_counter_ns() - t0
        )

    def report(self) -> Dict[str, dict]:
        return {
            name: {
                "total_us": s.total_ns / 1e3,
                "count": s.count,
                "min_us": s.min_ns / 1e3 if s.count else 0,
                "max_us": s.max_ns / 1e3,
            }
            for name, s in self.phases.items()
        }

    @staticmethod
    @contextlib.contextmanager
    def trace(log_dir: str, device="cuda"):
        """Device-level trace of the block through ``torch.profiler``,
        written as a Chrome trace (``trace.json``) into ``log_dir``. On a
        CUDA ``device`` the card's kernels are recorded; asking for CUDA
        where there is no card raises (the CPU is never traced in its
        place). Yields the ``torch.profiler.profile`` object."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        dev = torch.device(device)
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"QueryProfiler.trace: device {dev} asked for, but no "
                    "CUDA device is available"
                )
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield prof
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ProfileScope:
    """RAII phase scope (reference SearchProfiler.h ProfileScope): a phase
    of the thread's ``QueryProfiler`` (or of ``profiler``), and a range of
    the same name while ``torch.profiler`` records."""

    def __new__(cls, name: str, profiler: QueryProfiler = None):
        if (profiler is None and not _phases_on
                and not _torch_profiler._is_profiler_enabled):
            return _OFF
        return super().__new__(cls)

    def __init__(self, name: str, profiler: QueryProfiler = None):
        self.name = name
        self.profiler = profiler or QueryProfiler.current()
        self._range = None

    def __enter__(self):
        if _torch_profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            self._range.__enter__()
        self.profiler.begin_phase(self.name)
        return self

    def __exit__(self, *exc):
        self.profiler.end_phase(self.name)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


# the scope of a process that profiles nothing: one shared object
_OFF = contextlib.nullcontext()
