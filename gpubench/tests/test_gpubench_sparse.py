"""The sparse configuration's cell on the CPU at a tiny size: whole runs
with faults planted in its own adapter (``harness.sparse_system``), the
reference against the program, and a traced window that each of the
cell's per-layer metrics reads."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import cell as cells
from harness import check
from harness.drive import Call, Window, run_window, warm_up
from harness.sparse_system import System
from harness.traffic import make_pool
from tiny import SEED, run, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "msmarco-splade-1.1m.dev-b256"
METRICS = {"plan_ms.sparse", "route_ms.sparse", "light_ms.sparse",
           "light_rows_per_q.sparse", "groups_per_call.sparse"}


class _First(System):
    """Every call answers what the first call answered."""

    def collect(self, handle):
        res = super().collect(handle)
        if not hasattr(self, "first"):
            self.first = res
        return self.first


class _HalfBatch(System):
    """Half of each batch left out: the rest come back empty."""

    def dispatch(self, queries, k):
        self.n = len(queries)
        return super().dispatch(queries[: len(queries) // 2], k)

    def collect(self, handle):
        res = super().collect(handle)
        empty = (np.zeros(0, np.float32), np.zeros(0, np.int32), 0)
        return res + [empty] * (self.n - len(res))


class _Altered(System):
    """Each top score one float32 step up, where it is produced."""

    def collect(self, handle):
        out = []
        for scores, docs, hits in super().collect(handle):
            scores = np.array(scores, np.float32)
            if len(scores):
                scores[0] = np.nextafter(scores[0], np.float32(np.inf))
            out.append((scores, docs, hits))
        return out


@pytest.mark.parametrize("fault", [_First, _HalfBatch, _Altered],
                         ids=lambda f: f.__name__)
def test_planted_fault_is_not_correct(fault):
    r = run(tiny_cell(CELL), system_cls=fault)
    assert not r["correct"]
    assert r["checks"]["wrong_answers"]["value"] > 0


def test_reference_equals_program_on_cpu():
    """Every query of a tiny pool: the program's answer is the
    reference's, bit for bit."""
    cell = tiny_cell(CELL)
    generator, _, reference = cells.modules(cell.config)
    corpus = generator.make_corpus(cell.config, SEED, "cpu")
    pool = make_pool(cell.traffic, SEED)
    specs = [s for c in pool.calls for s in c][:128]
    system = System(corpus, "cpu")
    got = [System.answer(r) for r in system.collect(
        system.dispatch(System.queries(specs, pool.field), pool.k))]
    ref = reference.Reference.for_corpus(corpus, pool.field, cell.config,
                                         "cpu")
    numbers = check.compare(got, ref.answer(specs, pool.k), 0)
    assert numbers["wrong_answers"] == 0 and numbers["score_gap"] == 0.0
    assert all(h > 0 for h, _, _ in got)


def test_the_cell_and_its_metrics_are_in_the_benchmark():
    (cfg,) = [c for c in BENCH["configs"] if c["name"] == "msmarco-splade-1.1m"]
    assert cfg["reduced"] == ["num_docs"]
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in METRICS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "qps"
    assert set(tiny_cell(CELL).readers) == METRICS


@pytest.fixture(scope="module")
def traced():
    """A traced window of the program on the CPU at a tiny size, its
    batches partitioned as at 1.1M passages (a 194-row compact cap)."""
    c = tiny_cell(CELL)
    generator, adapter, _ = cells.modules(c.config)
    dev = torch.device("cpu")
    corpus = generator.make_corpus(c.config, SEED, dev)
    pool = make_pool(c.traffic, SEED)
    objects = [adapter.System.queries(q, pool.field) for q in pool.calls]
    system = adapter.System(corpus, dev)
    ex = system.searcher.executor
    ex.prune_min_docs = 0
    ex.COMPACT_GROUP_BYTES = 194 * 10 * system.searcher.num_docs_pad
    warm_up(system, pool, dev)
    w = run_window(system, pool, objects, 1.0, True, dev)
    system.close()
    return cells.RunData(w)


def test_traced_window_reports_each_metric(traced):
    ms = {m: read(traced) for m, read in tiny_cell(CELL).readers.items()}
    assert all(v is not None and v > 0 for v in ms.values()), ms
    assert ms["light_ms.sparse"] <= ms["route_ms.sparse"]
    assert ms["groups_per_call.sparse"] > 1
    assert 30 < ms["light_rows_per_q.sparse"] < 60


def _window(phases, counters):
    calls = [Call(0.0, 0.1, 0.1, 0.2, 256, False)] * 4
    return cells.RunData(Window(calls, [], counters, phases=phases))


def test_readers_on_a_program_without_the_spans_and_counters():
    """The parent program: no ``plan``/``light`` span in the sparse
    searcher and no ``search.light_rows``/``search.compact_groups``
    counter. The new readers return nothing; they never raise."""
    old = _window({"finalize": {"total_us": 10.0, "count": 4}},
                  {"search.escalations": 0})
    for name in METRICS - {"route_ms.sparse"}:
        assert cells.load_reader(name)(old) is None, name
    new = _window({"plan": {"total_us": 4000.0, "count": 4},
                   "light": {"total_us": 2000.0, "count": 12}},
                  {"search.light_rows": 43 * 1024,
                   "search.compact_groups": 12})
    assert cells.load_reader("plan_ms.sparse")(new) == pytest.approx(1.0)
    assert cells.load_reader("light_ms.sparse")(new) == pytest.approx(0.5)
    assert cells.load_reader("light_rows_per_q.sparse")(new) == 43
    assert cells.load_reader("groups_per_call.sparse")(new) == 3
