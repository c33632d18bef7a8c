"""The port's spans inside its search path (``plan``, ``route``, ``copy``,
``finalize``, ``escalate``, ``topdocs``) and the counters beside them: the
exact counts a call and segment, the escalation counters on a batch that
repeats escalating queries, a re-entered phase counted once, nothing
recorded and no profiler range opened where nothing profiles, the spans
as ranges in ``QueryProfiler.trace``'s Chrome trace, and the hand-kernel
launch counters in the registry."""

import json
import time

import numpy as np
import pytest

from diagon_tpu_torch import ops
from diagon_tpu_torch.document import Document, TextField
from diagon_tpu_torch.index.memory_index import MemoryIndex
from diagon_tpu_torch.index.segment import flush_memory_index
from diagon_tpu_torch.observability import profiler as prof_mod
from diagon_tpu_torch.observability.metrics import registry
from diagon_tpu_torch.observability.profiler import ProfileScope, QueryProfiler
from diagon_tpu_torch.search import BooleanQuery, IndexSearcher, Occur, TermQuery
from diagon_tpu_torch.search.oracle import OracleSearcher
from diagon_tpu_torch.search.query import BooleanClause

K = 10
# each hand kernel's wrapper: its module under diagon_tpu_torch.ops
KERNELS = {"row_sum": "row_sum", "row_boolean": "row_sum",
           "approx_select": "approx_pass", "approx_select_bool": "approx_pass",
           "approx_select_bool2": "approx_pass",
           "gather_rescore": "gather_rescore", "union_rescore": "gather_rescore",
           "bits_hits": "bits_hits", "range_agg": "range_agg",
           "block_score": "block_score"}


def _segment(n_docs, seed, vocab=60):
    rng = np.random.Generator(np.random.PCG64(seed))
    words = np.asarray([f"w{i}" for i in range(vocab)] + ["oil", "price"],
                       dtype=object)
    mem = MemoryIndex()
    for _ in range(n_docs):
        toks = rng.choice(words, max(3, int(rng.normal(20, 8))))
        mem.add_document(Document().add(TextField("body", " ".join(toks))))
    return flush_memory_index(mem, f"_s{seed}")


@pytest.fixture(scope="module")
def segments():
    return [_segment(1500, 3), _segment(700, 4)]


@pytest.fixture
def phases():
    """The thread's profiler, enabled for the test and off after it."""
    p = QueryProfiler.enable()
    yield p
    QueryProfiler._tls.profiler = QueryProfiler(enabled=False)


def _counts(p):
    return {n: r["count"] for n, r in p.report().items()}


def OR(*terms):
    return BooleanQuery([BooleanClause(TermQuery("body", t), Occur.SHOULD)
                         for t in terms])


@pytest.mark.parametrize("n_segments", [1, 2])
def test_term_search_span_counts(segments, phases, n_segments):
    """A term search: the JAX package's phases once, the row engine's
    spans (the batch entry's ``light`` bank among them) and the answers
    once a segment."""
    s = IndexSearcher(segments[:n_segments], device="cpu")
    s.search(TermQuery("body", "oil"), K)
    n = n_segments
    assert _counts(phases) == {"plan": 1, "execute": 1, "merge": 1,
                               "route": n, "finalize": n, "copy": n,
                               "topdocs": n, "light": n}


@pytest.mark.parametrize("n_segments", [1, 2])
def test_dispatch_and_collect_span_counts(segments, phases, n_segments):
    """A batch: ``plan``, ``route``, the one copy and the answers once a
    call; ``finalize`` and the batch entry's ``light`` bank once a
    segment. Nothing escalates below the pruned route's size."""
    s = IndexSearcher(segments[:n_segments], device="cpu")
    qs = [TermQuery("body", "oil"), OR("w1", "price"), OR("w2", "w3")] * 4
    h = s.dispatch_batch(qs, K)
    (res,) = s.collect_many([h])
    assert len(res) == len(qs)
    assert _counts(phases) == {"plan": 1, "route": 1, "copy": 1,
                               "finalize": n_segments, "topdocs": 1,
                               "light": n_segments}


def test_escalating_batch_counts_its_distinct_plans(segments, phases):
    """A starved tile budget fails the certificates of a batch that
    repeats two queries: every row escalates, ``search.escalated_plans``
    counts the two plans, the answers stay exact; a ``light`` bank for
    the batch's entry and one for the escalated rows' entry."""
    s = IndexSearcher(segments[:1], device="cpu")
    ex = s._ctx("body").row_executors[0]
    ex.prune_min_docs = ex.prune_solo_min_docs = 0
    ex.prune_B0 = 2
    ex.approx_min_q = 1
    qa, qb = OR("w1", "w2", "w3", "w4", "w5"), OR("w7", "oil")
    qs = [qa] * 5 + [qb] * 3
    before = registry.snapshot()
    (res,) = s.collect_many([s.dispatch_batch(qs, K)])
    after = registry.snapshot()
    delta = {n: after[n] - before.get(n, 0)
             for n in ("search.escalations", "search.escalated_plans",
                       "search.pruned_dispatches")}
    assert delta == {"search.escalations": 8, "search.escalated_plans": 2,
                     "search.pruned_dispatches": 1}
    assert _counts(phases) == {"plan": 1, "route": 1, "copy": 1,
                               "finalize": 1, "escalate": 1, "topdocs": 1,
                               "light": 2}
    oracle = OracleSearcher(segments[:1])
    for q, td in zip(qs, res):
        want = oracle.search(q, K)
        assert td.total_hits == want.total_hits
        assert td.doc_ids() == want.doc_ids()


def test_reentered_phase_is_counted_once(phases):
    """Only the outermost of nested scopes of one name is timed and
    counted, and the inner one restarts no clock; other names nest as
    before."""
    with ProfileScope("a"):
        time.sleep(0.002)
        with ProfileScope("a"):
            with ProfileScope("b"):
                pass
        with ProfileScope("a"):
            pass
    phases.begin_phase("m")
    phases.begin_phase("m")
    phases.end_phase("m")
    phases.end_phase("m")
    rep = phases.report()
    assert {n: r["count"] for n, r in rep.items()} == {"a": 1, "b": 1, "m": 1}
    assert rep["a"]["total_us"] >= 2000


class _Ranges:
    """Stands in for the profiler range: counts the ranges opened."""

    opened = 0

    def __init__(self, name):
        type(self).opened += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def test_nothing_profiles_nothing_recorded(segments, monkeypatch):
    """With no profiler ever enabled and no torch.profiler session, a
    scope is the one shared scope that does nothing: a search opens no
    range and leaves the thread's profiler empty."""
    monkeypatch.setattr(prof_mod, "_phases_on", False)
    monkeypatch.setattr(prof_mod, "_Range", _Ranges)
    monkeypatch.setattr(_Ranges, "opened", 0)
    p = QueryProfiler(enabled=False)
    monkeypatch.setattr(QueryProfiler._tls, "profiler", p, raising=False)
    assert ProfileScope("plan") is ProfileScope("route") is prof_mod._OFF
    s = IndexSearcher(segments[:1], device="cpu")
    s.search(TermQuery("body", "oil"), K)
    s.collect_many([s.dispatch_batch([OR("w1", "w2")] * 3, K)])
    assert p.report() == {} and _Ranges.opened == 0


def test_disabled_profiler_records_no_phases_and_no_ranges(segments,
                                                           monkeypatch):
    """Once a profiler was enabled in the process, a thread whose
    profiler is off still records nothing and opens no range."""
    QueryProfiler.enable()
    p = QueryProfiler(enabled=False)
    QueryProfiler._tls.profiler = p
    monkeypatch.setattr(prof_mod, "_Range", _Ranges)
    monkeypatch.setattr(_Ranges, "opened", 0)
    s = IndexSearcher(segments[:1], device="cpu")
    s.search(TermQuery("body", "oil"), K)
    assert p.report() == {} and _Ranges.opened == 0


def test_chrome_trace_holds_the_spans_inside_execute(segments, tmp_path):
    """``QueryProfiler.trace`` around a search, with the phase profiler
    off: each span is a range of the trace, ``route``, ``copy``,
    ``finalize`` and ``topdocs`` inside ``execute``, the copy inside
    ``finalize``."""
    QueryProfiler._tls.profiler = QueryProfiler(enabled=False)
    s = IndexSearcher(segments[:1], device="cpu")
    with QueryProfiler.trace(str(tmp_path), device="cpu"):
        s.search(OR("w1", "w2"), K)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in (
                "plan", "execute", "route", "copy", "finalize", "topdocs",
                "merge"):
            assert e["name"] not in spans, e["name"]  # one of each
            spans[e["name"]] = (e["ts"], e["ts"] + e["dur"])

    def inside(inner, outer):
        return spans[outer][0] <= spans[inner][0] <= spans[inner][1] \
            <= spans[outer][1]

    assert set(spans) == {"plan", "execute", "route", "copy", "finalize",
                          "topdocs", "merge"}
    assert spans["plan"][1] <= spans["execute"][0]
    for name in ("route", "copy", "finalize", "topdocs"):
        assert inside(name, "execute"), name
    assert inside("copy", "finalize")
    assert spans["route"][1] <= spans["finalize"][0] <= spans["topdocs"][0]


def test_no_span_takes_a_harness_name():
    """The benchmark's own spans are ``dispatch``, ``wait``, ``collect``
    and ``search``; a program range of such a name would be read as one
    of them."""
    import inspect

    from diagon_tpu_torch.search import row_engine, searcher

    src = inspect.getsource(searcher) + inspect.getsource(row_engine)
    for name in ("dispatch", "wait", "collect", "search"):
        assert f'ProfileScope("{name}")' not in src


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_launches_are_registry_counters(kernel):
    """Each hand kernel's launches are the registry counter
    ``ops.<kernel>.launches``, which the CPU path never moves; the
    wrappers carry no count of their own."""
    import importlib

    module = importlib.import_module(f"diagon_tpu_torch.ops.{KERNELS[kernel]}")
    wrapper = getattr(module, kernel)
    assert not hasattr(wrapper, "launches")
    snap = registry.snapshot()
    assert isinstance(snap[f"ops.{kernel}.launches"], int)
    assert ops.launches(kernel) == snap[f"ops.{kernel}.launches"]
    assert ops.launch_counter(kernel) is ops.launch_counter(kernel)


def test_nvcc_seconds_is_a_registry_gauge():
    from diagon_tpu_torch.ops import _build

    assert not hasattr(_build, "build_seconds")
    assert isinstance(registry.snapshot()["ops.nvcc_seconds"], float)
