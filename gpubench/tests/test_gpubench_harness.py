"""The harness on the CPU at a tiny size: whole runs past the look for a
card, with the program sound and with faults planted under the timed
path; the run's refusals; the files BENCHMARK.json names; the trace
reduction."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from harness import cell as cells
from harness.devtrace import summarize
from harness.system import System
from tiny import SEED, run, tiny_cell

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
BATCH = [w["name"] for w in BENCH["workloads"]
         if cells.load_cell(w["name"]).traffic["batch_size"] > 1]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(tiny_cell(name))
    assert r["correct"], r["checks"]
    assert r["checks"]["answers_compared"]["value"] > 0
    assert r["failed"] == 0 and r["attempted"] > 0
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    # device_mib comes from the card's allocator, so a CPU run lacks it
    assert set(r["metrics"]) == e2e - {"device_mib"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"


class _First(System):
    """A step that returns its state unchanged: every call answers what
    the first call answered."""

    def _same(self, res):
        if not hasattr(self, "first"):
            self.first = res
        return self.first

    def collect(self, handle):
        return self._same(super().collect(handle))

    def search(self, query, k):
        return self._same(super().search(query, k))


class _HalfBatch(System):
    """Half of each batch left out: the rest come back empty."""

    def dispatch(self, queries, k):
        self.n = len(queries)
        return super().dispatch(queries[: len(queries) // 2], k)

    def collect(self, handle):
        res = super().collect(handle)
        return res + [type(res[0])(0, [])] * (self.n - len(res))


def _nudge(td):
    """An answer altered where it is produced: its top score one float32
    step up."""
    if not td.score_docs:
        return td
    top = td.score_docs[0]
    up = float(np.nextafter(np.float32(top.score), np.float32(np.inf)))
    return type(td)(td.total_hits,
                    [type(top)(top.doc, up)] + list(td.score_docs[1:]))


class _Altered(System):
    def collect(self, handle):
        return [_nudge(td) for td in super().collect(handle)]

    def search(self, query, k):
        return _nudge(super().search(query, k))


FAULTS = [(n, f) for n in CELLS for f in (_First, _Altered)] + \
         [(n, _HalfBatch) for n in BATCH]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_planted_fault_is_not_correct(name, fault):
    r = run(tiny_cell(name), system_cls=fault)
    assert not r["correct"]
    assert r["checks"]["wrong_answers"]["value"] > 0


def test_traced_run_without_device_time_fails():
    """A trace that holds no device operation fails the run; it never
    reports 0."""
    with pytest.raises(RuntimeError, match="no device time"):
        run(tiny_cell("reuters-19k.solo"), trace=True)


def test_run_path_loads_no_jax():
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "sys.path.insert(0, %r)\n"
        "from tiny import run, tiny_cell\n"
        "r = run(tiny_cell('reuters-19k.table-b1024'), seconds=0.5)\n"
        "from harness import cell\n"
        "print(cell.forbidden_modules()); sys.exit(1 if cell.forbidden_modules() "
        "or not r['correct'] else 0)\n" % (str(HERE), str(ROOT), str(HERE / "tests"))
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]
    # top-level names compare whole: the port's name begins with the JAX
    # package's, and is allowed
    assert "diagon_tpu_torch" not in cells.FORBIDDEN


def test_run_without_a_card_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", CELLS[0], "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT)
    assert res.returncode == 2 and res.stdout == ""


def test_benchmark_alone_cannot_run(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder has no program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys; sys.path[:0] = ['gpubench', 'gpubench/tests', '.']\n"
        "from tiny import run, tiny_cell\n"
        "run(tiny_cell('reuters-19k.solo'))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path)
    assert res.returncode != 0 and res.stdout == ""
    assert "diagon_tpu_torch" in res.stderr


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_names_files_and_limits():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gpubench"] and 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert cells.load_reader(m["name"])
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and NAME.match(c["name"])
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert c["file"].startswith("gpubench/")
        for m in cells.modules(cfg):  # the generator, adapter, reference
            assert Path(m.__file__).resolve().is_relative_to(HERE)
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        cell = cells.load_cell(w["name"])
        assert (HERE / "modes" / f"{cell.traffic['mode']}.py").exists()
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        assert len(cell.end_to_end) >= 2 and cell.readers
    assert len(json.dumps(b)) < 64 * 1024


def _ev(name, kind, a, z, dev="DeviceType.CUDA"):
    return SimpleNamespace(
        name=lambda: name, activity_type=lambda: kind,
        device_type=lambda: dev, start_ns=lambda: a, duration_ns=lambda: z - a)


def test_trace_reduction():
    host = "DeviceType.CPU"
    events = [
        _ev("dispatch", "user_annotation", 0, 400, host),
        _ev("collect", "user_annotation", 400, 1000, host),
        _ev("k1", "kernel", 100, 300),
        _ev("k1", "kernel", 250, 350),
        _ev("Memcpy DtoH", "gpu_memcpy", 500, 600),
        _ev("dispatch", "gpu_user_annotation", 0, 1000),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    t = summarize(prof, ("dispatch", "collect"))
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx(350e-9)
    assert t.kernels == 2 and t.kernel_s == pytest.approx(300e-9)
    assert t.device_ops[0][0] == "k1"
    gaps = dict((round(s * 1e9), n) for n, s in t.idle_gaps)
    assert gaps == {100: "dispatch", 150: "collect", 400: "collect"}
