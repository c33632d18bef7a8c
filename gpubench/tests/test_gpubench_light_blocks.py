"""The reader of the program's ``search.light_blocks`` counter,
``light_blocks_per_q.sparse``: its entry in the benchmark, on planted
windows (blocks a query; nothing without the counter, as on a program
that lacks it), and on a traced window of the sparse cell at a tiny size
on the CPU, where every light row decodes at least one block."""

import json
from pathlib import Path

import pytest
import torch

from harness import cell as cells
from harness.drive import Call, Window, run_window, warm_up
from harness.traffic import make_pool
from tiny import SEED, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "msmarco-splade-1.1m.dev-b256"
METRIC = "light_blocks_per_q.sparse"


def _window(counters, queries=256, calls=4):
    return cells.RunData(Window([Call(0.0, 0.1, 0.1, 0.2, queries, False)]
                                * calls, [], counters, phases={}))


def test_the_metric_is_in_the_benchmark_for_the_sparse_cell():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == METRIC]
    assert m["workloads"] == [CELL] and m["moves"] == "qps"
    assert m["source"] == "program_counter" and m["layer"] == "row engine"
    assert METRIC in tiny_cell(CELL).readers
    assert METRIC not in tiny_cell("reuters-19k.table-b1024").readers


def test_reader_on_planted_windows():
    read = cells.load_reader(METRIC)
    run = _window({"search.light_blocks": 4 * 256 * 1500,
                   "search.light_rows": 4 * 256 * 43})
    assert read(run) == pytest.approx(1500.0)
    assert read(_window({"search.light_blocks": 0})) == 0.0
    # the parent program: no such counter, nothing to read
    assert read(_window({"search.light_rows": 43})) is None
    assert read(_window({"search.light_blocks": 5}, queries=0)) is None


def test_traced_window_reads_at_least_a_block_a_light_row():
    c = tiny_cell(CELL)
    generator, adapter, _ = cells.modules(c.config)
    dev = torch.device("cpu")
    corpus = generator.make_corpus(c.config, SEED, dev)
    pool = make_pool(c.traffic, SEED)
    objects = [adapter.System.queries(q, pool.field) for q in pool.calls]
    system = adapter.System(corpus, dev)
    warm_up(system, pool, dev)
    run = cells.RunData(run_window(system, pool, objects, 1.0, True, dev))
    system.close()
    blocks = c.readers[METRIC](run)
    rows = c.readers["light_rows_per_q.sparse"](run)
    assert rows > 0 and blocks >= rows
