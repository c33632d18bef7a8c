"""Warm-up and the measured window: a closed loop of one client.

A call's shape is the traffic's ``mode``, a module ``modes/<mode>.py``
found by name (``batch``: ``dispatch`` then ``collect``; ``solo``:
``search``). Every call sends fresh query objects. Each call's host
times are recorded; with tracing on, the program's phase profiler is on
and ``torch.profiler`` covers a bounded stretch of the window, the
harness's spans marked in it with ``record_function``. The window's
thread runs on one fixed core.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from harness.devtrace import TraceSummary, summarize
from harness.traffic import ORDER_LEN, Pool

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder

SPANS = ("dispatch", "wait", "collect", "search")
STRETCH_AT = 0.3  # the profiled stretch starts this share into the window
STRETCH_S = 2.0  # and lasts at most this long, or the traffic's stretch_calls


@dataclass
class Call:
    start: float
    dispatched: float  # batch: dispatch returned; solo: = end
    synced: float  # traced batch: the device wait ended; else = dispatched
    end: float
    queries: int
    profiled: bool


@dataclass
class Window:
    calls: List[Call]
    kept: List[tuple]  # (pool call, position, the adapter's answer)
    counters: Dict[str, int]  # the program's counters, window delta
    phases: Dict[str, dict] = field(default_factory=dict)  # unprofiled calls
    trace: Optional[TraceSummary] = None
    failures: int = 0  # queries whose call raised
    gc_pauses: List[float] = field(default_factory=list)  # full collections, s
    core: Optional[int] = None  # the core the window ran on

    @property
    def seconds(self) -> float:
        return self.calls[-1].end - self.calls[0].start if self.calls else 0.0

    @property
    def queries(self) -> int:
        return sum(c.queries for c in self.calls)


def load_mode(name: str):
    path = HERE / "modes" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_mode_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Driver:
    def __init__(self, system, pool: Pool, device):
        self.system = system
        self.pool = pool
        self.mode = load_mode(pool.mode)
        self.cuda = torch.device(device).type == "cuda"

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def call(self, obj, trace: bool, mark: bool):
        """One call with fresh copies of the query objects ``obj``:
        (Call, its answers)."""
        span = (torch.profiler.record_function if mark
                else lambda _: contextlib.nullcontext())
        qs = [self.system.fresh(q) for q in obj]
        times, res = self.mode.call(self.system, qs, self.pool.k, trace,
                                    span, self._sync)
        return Call(*times, len(qs), mark), res


def warm_up(system, pool: Pool, device) -> None:
    """The warm-up's own calls: the window's shapes, none of its calls."""
    d = _Driver(system, pool, device)
    for w in pool.warmup:
        d.call(system.queries(w, pool.field), trace=False, mark=False)
    d._sync()


def _phase_delta(after: Dict[str, dict], before: Dict[str, dict]) -> Dict[str, dict]:
    out = {}
    for name, s in after.items():
        b = before.get(name, {"total_us": 0.0, "count": 0})
        out[name] = {"total_us": s["total_us"] - b["total_us"],
                     "count": s["count"] - b["count"]}
    return out


def run_window(system, pool: Pool, objects: List, seconds: float, trace: bool,
               device) -> Window:
    d = _Driver(system, pool, device)
    phase_prof = system.enable_phase_profiler() if trace else None
    c0 = system.counters()
    calls: List[Call] = []
    kept: List[tuple] = []
    failures = 0
    prof = None
    stretch = None  # (phases before, phases after) around the stretch
    summary = None
    pauses: List[float] = []
    gc_t0 = [0.0]

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                gc_t0[0] = time.perf_counter()
            else:
                pauses.append(time.perf_counter() - gc_t0[0])

    gc.callbacks.append(on_gc)
    cores = os.sched_getaffinity(0)
    core = max(cores)  # this thread alone; threads started before keep theirs
    os.sched_setaffinity(0, {core})
    t_start = time.perf_counter()
    t_end = t_start + seconds
    t_prof = t_start + STRETCH_AT * seconds
    stretch_len = min(STRETCH_S, 0.2 * seconds)
    n_prof = 0
    i = 0
    while True:
        now = time.perf_counter()
        if now >= t_end and (not trace or summary is not None):
            break
        if trace and prof is None and summary is None and now >= t_prof:
            d._sync()
            stretch = [phase_prof.report(), None]
            acts = [torch.profiler.ProfilerActivity.CPU]
            if d.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            p_start = time.perf_counter()
        marked = prof is not None
        slot = i % ORDER_LEN
        pi = int(pool.order[slot])
        try:
            call, res = d.call(objects[pi], trace, marked)
        except Exception:  # answers that never come: counted, and the loop goes on
            if not failures:
                traceback.print_exc(file=sys.stderr)
            failures += len(objects[pi])
            res = None
        if res is not None:
            calls.append(call)
            for pos in pool.keep[slot]:
                kept.append((pi, pos, d.system.answer(res[pos])))
        i += 1
        if marked:
            n_prof += 1
            if (time.perf_counter() - p_start >= stretch_len
                    or n_prof >= pool.stretch_calls):
                d._sync()
                prof.__exit__(None, None, None)
                stretch[1] = phase_prof.report()
                summary = summarize(prof, SPANS)
                prof = None
    d._sync()
    os.sched_setaffinity(0, cores)
    gc.callbacks.remove(on_gc)
    counters = system.counters()
    w = Window(calls, kept, {n: v - c0.get(n, 0) for n, v in counters.items()},
               failures=failures, gc_pauses=pauses, core=core)
    if trace:
        before, after = stretch
        w.phases = _phase_delta(phase_prof.report(),
                                _phase_delta(after, before))
        w.trace = summary
    return w
