"""The readers of the program's spans and of its escalated-plans counter:
on planted windows (a span's total over the calls outside the profiled
stretch, 0.0 without the span, nothing without phases or counter), and
on a traced window of the program at a tiny size on the CPU, where the
program's spans lie inside the harness's."""

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
SPANS = {"plan_ms.batch": "plan", "route_ms.batch": "route",
         "route_ms.solo": "route", "copy_ms.batch": "copy",
         "finalize_ms.batch": "finalize", "escalate_ms.batch": "escalate",
         "topdocs_ms.batch": "topdocs"}
COUNTER = "escalated_plans_per_kq.batch"


def _window(phases, counters=None, profiled=1, unprofiled=4, queries=256):
    calls = [Call(0.0, 0.1, 0.1, 0.2, queries, False)] * unprofiled + \
            [Call(0.0, 0.1, 0.1, 0.2, queries, True)] * profiled
    return cells.RunData(Window(calls, [], counters or {}, phases=phases))


def test_every_new_metric_is_in_the_benchmark():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    batch = ["rcv1-804k.table-b1024", "reuters-19k.table-b1024"]
    for name in [*SPANS, COUNTER]:
        m = per_layer[name]
        assert m["workloads"] == (["reuters-19k.solo"]
                                  if name.endswith(".solo") else batch)
        assert m["source"] == ("program_counter" if name == COUNTER
                               else "program_span")


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader_on_a_planted_window(metric):
    read = cells.load_reader(metric)
    phase = SPANS[metric]
    # 6,000 us of the span over the four calls outside the stretch
    run = _window({phase: {"total_us": 6000.0, "count": 4},
                   "other": {"total_us": 1.0, "count": 1}})
    assert read(run) == pytest.approx(1.5)
    assert read(_window({"other": {"total_us": 1.0, "count": 1}})) == 0.0
    assert read(_window({})) is None
    assert read(_window({phase: {"total_us": 1.0, "count": 1}},
                        unprofiled=0)) is None


def test_escalated_plans_reader_on_a_planted_window():
    read = cells.load_reader(COUNTER)
    run = _window({}, {"search.escalated_plans": 3, "search.escalations": 90},
                  profiled=0, unprofiled=6, queries=500)
    assert read(run) == pytest.approx(1.0)  # 3 a 3,000 queries
    assert read(_window({}, {"search.escalated_plans": 0})) == 0.0
    # a program without the counter: nothing to read
    assert read(_window({}, {"search.escalations": 5})) is None


def _traced(name):
    """A traced window of the program on the CPU at a tiny size."""
    c = tiny_cell(name)
    generator, adapter, _ = cells.modules(c.config)
    dev = torch.device("cpu")
    corpus = generator.make_corpus(c.config, SEED, dev)
    pool = make_pool(c.traffic, SEED)
    objects = [adapter.System.queries(q, pool.field) for q in pool.calls]
    system = adapter.System(corpus, dev)
    warm_up(system, pool, dev)
    w = run_window(system, pool, objects, 1.0, True, dev)
    system.close()
    return cells.RunData(w)


@pytest.fixture(scope="module")
def batch_run():
    return _traced("reuters-19k.table-b1024")


@pytest.fixture(scope="module")
def solo_run():
    return _traced("reuters-19k.solo")


def _mine(name):
    return {m: r for m, r in tiny_cell(name).readers.items()
            if m in SPANS or m == COUNTER}


def test_traced_batch_window_reports_each_new_metric(batch_run):
    mine = _mine("reuters-19k.table-b1024")
    assert set(mine) == set(SPANS) - {"route_ms.solo"} | {COUNTER}
    ms = {m: read(batch_run) for m, read in mine.items()}
    assert all(v is not None and v >= 0.0 for v in ms.values()), ms
    assert ms["route_ms.batch"] > 0 and ms["topdocs_ms.batch"] > 0


def test_traced_solo_window_reports_route_ms(solo_run):
    mine = _mine("reuters-19k.solo")
    assert set(mine) == {"route_ms.solo"}
    assert mine["route_ms.solo"](solo_run) > 0


def test_program_spans_lie_inside_the_harness_spans(batch_run):
    """A batch call's program spans add up to no more than the harness's
    span around the same call: ``plan`` and ``route`` inside ``dispatch``,
    ``copy``, ``finalize`` and ``topdocs`` inside ``collect``."""
    ms = {m: cells.load_reader(m)(batch_run) for m in (
        "dispatch_ms.batch", "collect_ms.batch", *SPANS)}
    assert ms["plan_ms.batch"] + ms["route_ms.batch"] \
        <= ms["dispatch_ms.batch"]
    assert ms["copy_ms.batch"] + ms["finalize_ms.batch"] \
        + ms["topdocs_ms.batch"] <= ms["collect_ms.batch"]
    assert ms["escalate_ms.batch"] <= ms["finalize_ms.batch"]
