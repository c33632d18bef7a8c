"""One run of one cell: corpus and traffic from the seed, the program's
index and searcher, warm-up, the measured window, the comparison with the
plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in ``BENCHMARK.json``:
``configs/<config>.json`` (the ``file`` of its entry),
``traffic/<traffic>.json`` and ``metrics/<metric>.py`` (a ``read(run)``
that returns the number, or None where the run holds nothing to read; a
metric split by cell kind, ``<base>.<kind>``, may share
``metrics/<base>.py``). The configuration names, as modules under the
benchmark's folder, its ``generator`` (``make_corpus(cfg, seed,
device)``), its ``adapter`` to the program (``System``) and its plain
``reference`` (``Reference.for_corpus``); the traffic names its call's
shape, ``modes/<mode>.py``. A new kind of system comes as files alone.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from harness import check
from harness.drive import Window, run_window, warm_up
from harness.traffic import make_pool

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diagon_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    readers: Dict[str, Callable]  # per-layer metric -> read(run)
    units: Dict[str, str]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(name: str) -> Callable:
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (wl,) = [w for w in bench["workloads"] if w["name"] == name]
    (cfg,) = [c for c in bench["configs"] if c["name"] == wl["config"]]
    config = json.loads((ROOT / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    return Cell(name, wl["chips"], config, traffic, e2e,
                {m["name"]: load_reader(m["name"]) for m in per_layer},
                {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]})


def modules(config: dict, keys=("generator", "adapter", "reference")):
    """The configuration's modules named by ``keys``: its generator,
    adapter and reference."""
    return tuple(importlib.import_module(config[k]) for k in keys)


@dataclass
class RunData:
    """What a per-layer reader reads."""

    window: Window

    @property
    def trace(self):
        return self.window.trace

    def host_calls(self):
        """The calls outside the profiled stretch."""
        return [c for c in self.window.calls if not c.profiled]

    def profiled_calls(self):
        return [c for c in self.window.calls if c.profiled]


def _p95(xs: List[float]) -> float:
    return float(np.percentile(np.asarray(xs), 95))


def _end_to_end(w: Window, setup_s: float, peak: Optional[int]) -> Dict[str, float]:
    lat = [(c.end - c.start) * 1e3 for c in w.calls]
    out = {"qps": w.queries / w.seconds, "setup_s": setup_s,
           "call_p95_ms": _p95(lat)}
    if peak is not None:
        out["device_mib"] = peak / 2**20
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_process: float, system_cls=None) -> dict:
    """One run; returns the result line's object. ``t_process`` is the
    process's start on ``time.time()``. ``system_cls`` stands in for the
    program's adapter (the tests plant faults through it)."""
    generator, adapter, reference = modules(cell.config)
    if system_cls is None:
        system_cls = adapter.System
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic

    t = time.perf_counter()
    corpus = generator.make_corpus(cfg, seed, dev)
    pool = make_pool(tr, seed)
    log(f"corpus and traffic: {time.perf_counter() - t:.3f} s, "
        f"{corpus.num_docs} docs, {len(pool.calls)} pool calls")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    objects = [system_cls.queries(c, pool.field) for c in pool.calls]
    # the harness's own objects (the query pool above all) leave the
    # collector's reach, so the program's collections do not pay for them
    gc.collect()
    gc.freeze()
    t = time.perf_counter()
    system = system_cls(corpus, dev)
    log(f"index build and load: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    warm_up(system, pool, dev)
    log(f"warm-up: {time.perf_counter() - t:.3f} s, {len(pool.warmup)} calls")
    setup_s = time.time() - t_process

    w = run_window(system, pool, objects, seconds, trace, dev)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    lat = np.asarray([(c.end - c.start) * 1e3 for c in w.calls])
    disp = np.asarray([(c.dispatched - c.start) * 1e3 for c in w.calls])
    log(f"window: {w.seconds:.3f} s, {len(w.calls)} calls, {w.queries} queries; "
        f"call ms p10/p25/p50/p75/p90/p95/max "
        f"{np.round(np.percentile(lat, [10, 25, 50, 75, 90, 95, 100]), 3).tolist()}; "
        f"dispatch ms median {np.median(disp):.3f}; first calls ms "
        f"{np.round(lat[:5], 3).tolist()}; full collections "
        f"{len(w.gc_pauses)}, {sum(w.gc_pauses):.3f} s, "
        f"longest {max(w.gc_pauses, default=0.0):.3f} s; core {w.core}")

    metrics: Dict[str, float] = {}
    breakdown = None
    if trace:
        if w.trace is None or w.trace.kernels == 0 or w.trace.busy_s <= 0:
            raise RuntimeError("the profiled stretch shows no device time")
        run = RunData(w)
        for name, read in cell.readers.items():
            v = read(run)
            if v is not None:
                metrics[name] = v
        breakdown = {"device_ops": [list(x) for x in w.trace.device_ops],
                     "idle_gaps": [list(x) for x in w.trace.idle_gaps]}
    else:
        e2e = _end_to_end(w, setup_s, peak)
        metrics = {m["name"]: e2e[m["name"]] for m in cell.end_to_end
                   if m["name"] in e2e}

    # the program's state is freed before the reference runs
    system.close()
    del system, objects
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference.Reference.for_corpus(corpus, pool.field, cfg, dev)
    specs = [pool.calls[pi][pos] for pi, pos, _ in w.kept]
    keys = list(dict.fromkeys(specs))  # a query answered once
    expected = dict(zip(keys, ref.answer(keys, pool.k)))
    numbers = check.compare([a for _, _, a in w.kept],
                            [expected[s] for s in specs], w.failures)
    ok, checks = check.verdict(numbers)
    log(f"reference: {time.perf_counter() - t:.3f} s for {len(keys)} distinct "
        f"queries, {numbers['answers_compared']} answers compared")

    result = {
        "correct": ok,
        "attempted": w.queries + w.failures,
        "failed": w.failures,
        "metrics": {n: {"value": v, "unit": cell.units[n]}
                    for n, v in metrics.items()},
        "device": {
            "platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": cell.chips,
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        result["device"]["busy_s"] = w.trace.busy_s
        result["device"]["window_s"] = w.trace.window_s
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
