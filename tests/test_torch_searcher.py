"""The PyTorch searcher end to end (device cpu) against the JAX searcher
(Pallas in interpret mode) and the host oracle: same docids, same f32
score bits, same hits, over deletes and multiple segments. Segments and
queries are built with the JAX package and carried into the port by
``convert``."""

import numpy as np
import pytest

from diagon_tpu.document import (
    Document,
    LongPointField,
    NumericDocValuesField,
    TextField,
)
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search.oracle import OracleSearcher
from diagon_tpu.search.query import (
    BooleanClause,
    BooleanQuery,
    MatchAllDocsQuery,
    NumericRangeQuery,
    Occur,
    PhraseQuery,
    PointRangeQuery,
    TermQuery,
)
from diagon_tpu.search.searcher import IndexSearcher as JaxSearcher
from diagon_tpu_torch.search import IndexSearcher
from diagon_tpu_torch.search.convert import query_from_jax, segment_from_jax

VOCAB = [f"w{i}" for i in range(40)] + ["oil", "price", "trade"]


def _segment(rng, n, name, delete_every=0):
    mem = MemoryIndex()
    for _ in range(n):
        words = rng.choice(VOCAB, size=int(rng.integers(4, 30)))
        mem.add_document(
            Document()
            .add(TextField("body", " ".join(words)))
            .add(TextField("title", " ".join(rng.choice(VOCAB[:10], 3))))
            .add(NumericDocValuesField("views", int(rng.integers(0, 100))))
            .add(LongPointField("ts", int(rng.integers(0, 1000))))
        )
    seg = flush_memory_index(mem, name)
    if delete_every:
        for d in range(3, n, delete_every):
            seg.delete_document(d)
    return seg


@pytest.fixture(scope="module")
def segs():
    rng = np.random.Generator(np.random.PCG64(2026))
    # the second segment crosses the 1024-doc pad; the first has deletes
    return [_segment(rng, 700, "_a", delete_every=9),
            _segment(rng, 1100, "_b")]


@pytest.fixture(scope="module")
def searchers(segs):
    return (IndexSearcher([segment_from_jax(s) for s in segs], device="cpu"),
            JaxSearcher(segs),
            OracleSearcher(segs))


def T(w, boost=1.0, field="body"):
    return TermQuery(field, w, boost=boost)


def B(*clauses, min_should=0):
    return BooleanQuery([BooleanClause(q, o) for q, o in clauses],
                        min_should)


M, S, F, N = Occur.MUST, Occur.SHOULD, Occur.FILTER, Occur.MUST_NOT

QUERIES = {
    "term": T("oil"),
    "term_boosted": T("w3", 2.5),
    "term_missing": T("never_indexed"),
    "and": B((T("oil"), M), (T("price"), M)),
    "or": B(*[(T(f"w{i}"), S) for i in range(0, 32, 4)]),
    "or_boosted_light": B((T("trade", 0.5), S), (T("w7"), S)),
    "must_should_not_filter_min_should": B(
        (T("oil"), M), (T("w1"), S), (T("w2"), S), (T("w3"), S),
        (T("w4"), N), (T("price"), F), min_should=2,
    ),
    "numeric_range_filter": B((T("trade"), M),
                              (NumericRangeQuery("views", 20, 60), F)),
    "point_range_should": B((T("w5"), S), (PointRangeQuery("ts", 900, None), S)),
    "range_must_not": B((T("oil"), M), (NumericRangeQuery("views", None, 30), N)),
    "standalone_range": NumericRangeQuery("views", 10, 12),
    "match_all_filtered": B((MatchAllDocsQuery(), M),
                            (PointRangeQuery("ts", 100, 300), F)),
    "nested_boolean": B(
        (B((T("oil"), S), (T("price"), S)), M),
        (B((T("w9"), M), (T("w10"), N)), S),
        (T("w11"), S),
    ),
    "nested_must_not_and_foreign_field": B(
        (T("trade"), S), (T("w2", field="title"), S),
        (B((T("w1"), S), (T("w6"), S)), N),
    ),
    "pure_must_not": B((T("oil"), N)),
}
BATCHABLE = [n for n in QUERIES if n != "pure_must_not"]
# the same queries as the port's own objects
PORT = {n: query_from_jax(q) for n, q in QUERIES.items()}


def _assert_same(got, want, what):
    assert got.total_hits == want.total_hits, what
    assert got.doc_ids() == want.doc_ids(), what
    np.testing.assert_array_equal(
        np.float32(got.scores()).view(np.uint32),
        np.float32(want.scores()).view(np.uint32),
        err_msg=what,
    )


@pytest.mark.parametrize("name", list(QUERIES))
def test_search_matches_jax_and_oracle(searchers, name):
    ts, js, oracle = searchers
    q = QUERIES[name]
    got = ts.search(PORT[name], 10)
    _assert_same(got, oracle.search(q, 10), f"{name} vs oracle")
    _assert_same(got, js.search(q, 10), f"{name} vs jax")


@pytest.mark.parametrize("name", list(QUERIES))
def test_count_matches_oracle(searchers, name):
    ts, _, oracle = searchers
    assert ts.count(PORT[name]) == oracle.count(QUERIES[name]), name


def test_search_batch_matches_jax(searchers):
    ts, js, oracle = searchers
    batch = [QUERIES[n] for n in BATCHABLE]
    got = ts.search_batch([PORT[n] for n in BATCHABLE], 7)
    want = js.search_batch(batch, 7)
    for name, q, g, w in zip(BATCHABLE, batch, got, want):
        _assert_same(g, w, f"{name} vs jax")
        _assert_same(g, oracle.search(q, 7), f"{name} vs oracle")


def test_dispatch_collect_many_matches_oracle(searchers):
    """Several handles in flight, one readback; duplicates in a batch take
    the identical-plan dedup and must not disturb the others."""
    ts, _, oracle = searchers
    b1 = [QUERIES[n] for n in BATCHABLE]
    b2 = [QUERIES["or"]] * 5 + [QUERIES["and"], QUERIES["or"]]
    p1 = [PORT[n] for n in BATCHABLE]
    p2 = [PORT["or"]] * 5 + [PORT["and"], PORT["or"]]
    handles = [ts.dispatch_batch(p1, 10), ts.dispatch_batch(p2, 10)]
    for batch, res in zip((b1, b2), ts.collect_many(handles)):
        assert len(res) == len(batch)
        for q, r in zip(batch, res):
            _assert_same(r, oracle.search(q, 10), repr(q))
    # collect_batch resolves one handle the same way
    for q, r in zip(b2, ts.collect_batch(ts.dispatch_batch(p2, 10))):
        _assert_same(r, oracle.search(q, 10), repr(q))


BATCH_PATHS = {
    "collect_many": lambda ts, qs, k: ts.collect_many(
        [ts.dispatch_batch(qs, k)])[0],
    "collect_batch": lambda ts, qs, k: ts.collect_batch(
        ts.dispatch_batch(qs, k)),
    "search_batch": lambda ts, qs, k: ts.search_batch(qs, k),
}


@pytest.mark.parametrize("path", list(BATCH_PATHS))
def test_batch_paths_equal_search_over_two_segments(searchers, path):
    """The batch paths build a batch's TopDocs with ``top_docs_batch``
    over both segments (deletes in the first, the second at a doc base of
    700): the same TopDocs as per-query ``search``, and the oracle's
    answers, at k below and at the segments' top-k width."""
    ts, _, oracle = searchers
    assert len(ts.device_segments) == 2 and ts.doc_bases[1] > 0
    for k in (3, 10):
        got = BATCH_PATHS[path](ts, [PORT[n] for n in BATCHABLE], k)
        assert len(got) == len(BATCHABLE)
        for name, g in zip(BATCHABLE, got):
            solo = ts.search(PORT[name], k)
            assert g == solo and repr(g) == repr(solo), (path, name, k)
            _assert_same(g, oracle.search(QUERIES[name], k), (path, name, k))
            assert all(type(sd.doc) is int and type(sd.score) is float
                       for sd in g.score_docs)


@pytest.mark.parametrize("path", [*BATCH_PATHS, "search"])
def test_topdocs_batched_counter(searchers, path):
    """``search.topdocs_batched`` counts the queries whose TopDocs the
    batch builder built: every query of a batch path, none of ``search``."""
    from diagon_tpu_torch.observability.metrics import registry

    ts = searchers[0]
    queries = [PORT[n] for n in BATCHABLE]
    counter = registry.counter("search.topdocs_batched")
    before = counter.value()
    if path == "search":
        for q in queries:
            ts.search(q, 10)
    else:
        BATCH_PATHS[path](ts, queries, 10)
    assert counter.value() - before == (0 if path == "search" else len(queries))


def test_exhaustive_chunks_equal_one_launch(searchers, monkeypatch):
    """Query chunking of exhaustive scoring changes nothing."""
    ts, _, oracle = searchers
    ex = ts._ctx("body").row_executors[1]
    monkeypatch.setattr(type(ex), "EXHAUSTIVE_CHUNK_BYTES", 3 * 4 * 4 * 2048)
    batch = [QUERIES[n] for n in BATCHABLE]
    got = ts.search_batch([PORT[n] for n in BATCHABLE], 10)
    for q, r in zip(batch, got):
        _assert_same(r, oracle.search(q, 10), repr(q))


ENTRY_POINTS = ["row_score_topk_pure_or_pallas", "row_score_topk_pure_or",
                "row_score_topk_pallas", "row_score_topk", "row_count"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_match_jax(searchers, name):
    """Each exhaustive entry point, fed the same stacked batch, returns
    the JAX function's fused rows (or counts) bit for bit."""
    import jax.numpy as jnp

    from diagon_tpu.search import row_engine as jre
    from diagon_tpu_torch.search import row_engine as tre

    ts = searchers[0]
    pure = name.endswith(("pure_or", "pure_or_pallas"))
    names = ["term", "or", "or_boosted_light", "term_missing"] if pure else BATCHABLE
    plans = [ts._query_plans(PORT[n])[1][1] for n in names]
    ex = ts._ctx("body").row_executors[1]
    args = ex._args(plans)
    if pure:
        args = args[:5]
    jargs = [jnp.asarray(a.numpy()) for a in args]
    kw = {} if name == "row_count" else {"k": 10}
    if name.endswith("pallas"):
        want = getattr(jre, name)(*jargs, interpret=True, **kw)
    else:
        want = getattr(jre, name)(*jargs, **kw)
    got = getattr(tre, name)(*args, **kw).numpy()
    want = np.asarray(want)
    if name == "row_count":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


PHRASES = [
    PhraseQuery("body", ["oil", "price"]),
    B((PhraseQuery("body", ["oil", "price"]), S), (T("w1"), S)),
    B((T("w1"), M), (B((PhraseQuery("body", ["w2", "w3"]), S),), N)),
]


@pytest.mark.parametrize("query", PHRASES)
def test_phrase_parity(searchers, query):
    """A solo phrase, a phrase SHOULD clause and a phrase in a MUST_NOT
    subtree, through search, count, search_batch and dispatch_batch +
    collect_many: equal to the JAX searcher and the oracle over deletes
    and two segments."""
    ts, js, oracle = searchers
    p = query_from_jax(query)
    want = oracle.search(query, 10)
    _assert_same(ts.search(p, 10), want, "search vs oracle")
    _assert_same(ts.search(p, 10), js.search(query, 10), "search vs jax")
    assert ts.count(p) == oracle.count(query) == js.count(query)
    _assert_same(ts.search_batch([p], 10)[0], want, "search_batch")
    _assert_same(js.search_batch([query], 10)[0], want, "jax search_batch")
    (got,) = ts.collect_many([ts.dispatch_batch([p, p], 10)])
    for g in got:
        _assert_same(g, want, "collect_many")


@pytest.mark.parametrize("batch", ["batchable", "phrases"])
def test_search_batch_is_dispatch_then_collect(searchers, batch):
    """``search_batch`` on a resident searcher is ``collect_batch`` of
    ``dispatch_batch``: the same TopDocs, query for query."""
    ts = searchers[0]
    qs = ([PORT[n] for n in BATCHABLE] if batch == "batchable"
          else [query_from_jax(q) for q in PHRASES])
    got = ts.search_batch(qs, 10)
    want = ts.collect_batch(ts.dispatch_batch(qs, 10))
    assert got == want and repr(got) == repr(want)


@pytest.mark.parametrize("batch", ["two_fields", "empty"])
def test_dispatch_batch_takes_one_field(searchers, batch):
    """A batch spans exactly one field: a body and a title query together,
    or no query at all, raise ValueError from both batch paths instead of
    scoring a query against another field's rows."""
    ts = searchers[0]
    qs = ([PORT["term"], query_from_jax(T("w2", field="title"))]
          if batch == "two_fields" else [])
    for call in (ts.dispatch_batch, ts.search_batch):
        with pytest.raises(ValueError, match="single field"):
            call(qs, 10)


def test_dispatch_and_collect_keep_no_query_alive(searchers):
    """The searcher keeps nothing of a batch's query objects once the
    caller drops them: the plans are cached by content, not by query."""
    import gc
    import weakref

    ts = searchers[0]
    qs = [query_from_jax(QUERIES[n]) for n in BATCHABLE]
    refs = [weakref.ref(q) for q in qs]
    (got,) = ts.collect_many([ts.dispatch_batch(qs, 10)])
    assert len(got) == len(BATCHABLE)
    del qs
    gc.collect()
    assert [r() for r in refs] == [None] * len(refs)


def test_kernel_launch_counters_stay_zero_on_cpu(searchers):
    from diagon_tpu_torch.ops import launches

    before = (launches("row_sum"), launches("row_boolean"))
    searchers[0].search_batch([PORT["or"], PORT["and"]], 10)
    assert (launches("row_sum"), launches("row_boolean")) == before


@pytest.mark.parametrize("name", ["term", "nested_boolean"])
def test_jax_query_objects_raise(searchers, name):
    """The searcher takes the port's query classes only: a JAX package
    query, or one nested in a port boolean, raises TypeError."""
    from diagon_tpu_torch.search.query import BooleanClause as PBC
    from diagon_tpu_torch.search.query import BooleanQuery as PBQ
    from diagon_tpu_torch.search.query import Occur as POccur

    ts = searchers[0]
    nested = PBQ([PBC(QUERIES[name], POccur.SHOULD)])
    for q in (QUERIES[name], nested):
        for call in (lambda: ts.search(q, 10), lambda: ts.count(q),
                     lambda: ts.search_batch([q], 10),
                     lambda: ts.dispatch_batch([q], 10)):
            with pytest.raises(TypeError, match="query_from_jax"):
                call()
