"""The port's phrase search (device cpu) against the JAX package and the
host oracle: ``phrase_positions_topk`` against the JAX function on seeded
inputs, ``PhraseExecutor`` against the JAX executor, and the searcher on
the JAX package's phrase cases (solo, counted, batched, nested, over
several segments and on the pruned batch route): same docids, same f32
score bits, same hits. Segments and queries are built with the JAX
package and carried into the port by ``convert``."""

import numpy as np
import pytest
import torch

from diagon_tpu.bench import queries as jq
from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search.oracle import OracleSearcher
from diagon_tpu.search.query import (
    BooleanClause,
    BooleanQuery,
    Occur,
    PhraseQuery,
    TermQuery,
)
from diagon_tpu.search.searcher import IndexSearcher as JaxSearcher
from diagon_tpu_torch.bench import queries as tq
from diagon_tpu_torch.search import IndexSearcher
from diagon_tpu_torch.search.convert import query_from_jax, segment_from_jax
from diagon_tpu_torch.search.engine import make_tf_table
from diagon_tpu_torch.search.phrase import phrase_positions_topk

K = 10
M, S, F, N = Occur.MUST, Occur.SHOULD, Occur.FILTER, Occur.MUST_NOT


def _segment(texts, name="_0"):
    mem = MemoryIndex()
    for t in texts:
        mem.add_document(Document().add(TextField("body", t)))
    return flush_memory_index(mem, name)


def _random_texts(rng, n_docs, vocab, mean_len=40):
    return [
        " ".join(rng.choice(vocab, size=max(1, int(rng.normal(mean_len,
                                                              mean_len / 3)))))
        for _ in range(n_docs)
    ]


VOCAB = np.asarray(
    [f"w{i}" for i in range(200)] + ["oil", "price", "trade", "market"],
    dtype=object,
)


def _same(got, want, what):
    assert got.total_hits == want.total_hits, what
    assert got.doc_ids() == want.doc_ids(), what
    np.testing.assert_array_equal(
        np.float32(got.scores()).view(np.uint32),
        np.float32(want.scores()).view(np.uint32),
        err_msg=str(what),
    )


# ---------------------------------------------------------------------------
# phrase_positions_topk against the JAX function
# ---------------------------------------------------------------------------


def _positions_inputs(seed, n_terms, C, n_cand, zero_entries):
    """Seeded inputs of both functions: per-term entries of 0-9 ascending
    positions (``zero_entries``: some entries hold none, an empty window),
    candidates ascending with -1 padding past ``n_cand``, norms from three
    values so that equal scores tie."""
    rng = np.random.Generator(np.random.PCG64(seed))
    NE = 400
    counts = rng.integers(0 if zero_entries else 1, 10, NE)
    pos_start = np.zeros(NE + 1, np.int32)
    np.cumsum(counts, out=pos_start[1:])
    positions = np.concatenate([
        np.sort(rng.choice(14, c, replace=False)) for c in counts
    ]).astype(np.int32)
    D = 1024
    norms = rng.choice(np.asarray([3, 40, 90], np.int32), D)
    cand = np.full(C, -1, np.int32)
    cand[:n_cand] = np.sort(rng.choice(D, n_cand, replace=False))
    ent = rng.integers(0, NE, (n_terms, C)).astype(np.int32)
    caps = tuple(max(4, 1 << int(np.ceil(np.log2(max(1, counts.max())))))
                 for _ in range(n_terms))
    tf_lut = make_tf_table(np.float32(37.5), int(counts.max()))
    return pos_start, positions, norms, tf_lut, cand, ent, caps


@pytest.mark.parametrize("n_terms,lead,C,n_cand,k,zero", [
    (2, 0, 64, 50, 10, False),
    (2, 1, 64, 64, 64, False),  # lead not 0, k = C
    (3, 2, 128, 100, 17, True),  # empty windows
    (3, 1, 8, 5, 8, True),
    (1, 0, 32, 20, 5, False),  # a one-term phrase
])
def test_positions_topk_matches_jax(n_terms, lead, C, n_cand, k, zero):
    import jax.numpy as jnp

    from diagon_tpu.search.phrase import phrase_positions_topk as jax_topk

    pos_start, positions, norms, tf_lut, cand, ent, caps = _positions_inputs(
        100 + C + n_terms, n_terms, C, n_cand, zero)
    idf = np.float32(1.7320508)
    want = np.asarray(jax_topk(
        jnp.asarray(pos_start), jnp.asarray(positions), jnp.asarray(norms),
        jnp.asarray(tf_lut), jnp.asarray(cand), jnp.asarray(ent),
        jnp.float32(idf), pos_caps=caps, lead=lead, k=k,
    ))
    t = torch.from_numpy
    scores, docs, hits = phrase_positions_topk(
        t(pos_start), t(positions), t(norms), t(tf_lut), t(cand), t(ent),
        torch.tensor(idf), pos_caps=caps, lead=lead, k=k,
    )
    np.testing.assert_array_equal(scores.numpy().view(np.uint32),
                                  want[:k].view(np.uint32))
    np.testing.assert_array_equal(docs.numpy(), want[k : 2 * k].astype(np.int32))
    assert int(hits) == int(want[2 * k])
    # the case exercises ties, matches and a non-match
    assert 0 < int(hits) < n_cand or n_terms == 1


def test_positions_chunks_change_nothing(monkeypatch):
    """The candidate axis in chunks gives what one pass gives."""
    from diagon_tpu_torch.search import phrase

    args = _positions_inputs(7, 3, 128, 120, True)
    pos_start, positions, norms, tf_lut, cand, ent, caps = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
    kw = dict(pos_caps=caps, lead=1, k=40)
    one = phrase_positions_topk(pos_start, positions, norms, tf_lut, cand, ent,
                                torch.tensor(np.float32(2.5)), **kw)
    monkeypatch.setattr(phrase, "_CHUNK_ELEMS", 3 * sum(caps))
    many = phrase_positions_topk(pos_start, positions, norms, tf_lut, cand,
                                 ent, torch.tensor(np.float32(2.5)), **kw)
    assert torch.equal(one[0].view(torch.int32), many[0].view(torch.int32))
    assert torch.equal(one[1], many[1]) and torch.equal(one[2], many[2])


# ---------------------------------------------------------------------------
# PhraseExecutor against the JAX executor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def random_index():
    """The corpus of tests/unit/test_device_engine.py's random_index."""
    rng = np.random.Generator(np.random.PCG64(42))
    seg = _segment(_random_texts(rng, 700, VOCAB))
    return (seg, OracleSearcher([seg]), JaxSearcher([seg]),
            IndexSearcher([segment_from_jax(seg)], device="cpu"))


PHRASES = [["oil", "price"], ["price", "oil"], ["w1", "w2", "w3"],
           ["oil"], ["w5", "w5"], ["oil", "never_indexed"]]


@pytest.mark.parametrize("terms", PHRASES)
def test_executor_matches_jax(random_index, terms):
    _, _, js, ts = random_index
    jex = js._phrase_executors("body")[0]
    tex = ts._phrase_executors("body")[0]
    q = PhraseQuery("body", terms)
    idf = js._phrase_idf(q)
    assert ts._phrase_idf(query_from_jax(q)) == idf
    for k in (1, 10, 500):  # 500 > C: the padded tail
        got, want = tex.top_k(terms, idf, k), jex.top_k(terms, idf, k)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got[0].view(np.uint32),
                                      want[0].view(np.uint32))
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    for got, want in zip(tex.score_row(terms, idf, 700),
                         jex.score_row(terms, idf, 700)):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(want).view(np.uint32))


# ---------------------------------------------------------------------------
# The searcher: search, count, search_batch, dispatch_batch + collect_many
# ---------------------------------------------------------------------------


def _four_ways(ts, js, oracle, queries, k=K):
    """Each query through the port's search, count, search_batch and
    dispatch_batch + collect_many, against the JAX searcher and the
    oracle."""
    pq = [query_from_jax(q) for q in queries]
    batch = ts.search_batch(pq, k)
    (many,) = ts.collect_many([ts.dispatch_batch(pq, k)])
    want_batch = js.search_batch(queries, k)
    for q, p, b, m, wb in zip(queries, pq, batch, many, want_batch):
        want = oracle.search(q, k)
        _same(ts.search(p, k), want, ("search", q))
        _same(ts.search(p, k), js.search(q, k), ("search vs jax", q))
        _same(b, want, ("search_batch", q))
        _same(m, want, ("collect_many", q))
        _same(wb, want, ("jax search_batch", q))
        assert ts.count(p) == oracle.count(q) == js.count(q), q


def test_device_engine_phrase_cases(random_index):
    """tests/unit/test_device_engine.py::test_phrase_parity."""
    _, oracle, js, ts = random_index
    _four_ways(ts, js, oracle,
               [PhraseQuery("body", t) for t in
                (["oil", "price"], ["price", "oil"], ["w1", "w2", "w3"])])


def test_multi_segment_phrase():
    """tests/unit/test_device_engine.py::test_multi_segment_parity."""
    rng = np.random.Generator(np.random.PCG64(43))
    segs = [_segment(_random_texts(rng, n, VOCAB), name=f"_{i}")
            for i, n in enumerate([150, 400, 80])]
    ts = IndexSearcher([segment_from_jax(s) for s in segs], device="cpu")
    _four_ways(ts, JaxSearcher(segs), OracleSearcher(segs),
               [PhraseQuery("body", ["oil", "price"]),
                TermQuery("body", "oil")])


def _nested_corpus(n=700, seed=17):
    """tests/unit/test_nested_boolean.py's corpus (body and title), with
    "oil price" planted in every 11th doc."""
    rng = np.random.Generator(np.random.PCG64(seed))
    words = [f"w{i}" for i in range(40)] + ["oil", "price", "trade"]
    mem = MemoryIndex()
    for i in range(n):
        toks = list(rng.choice(words, max(4, int(rng.normal(22, 6)))))
        if i % 11 == 0:
            off = int(rng.integers(0, len(toks) - 1))
            toks[off : off + 2] = ["oil", "price"]
        mem.add_document(Document()
                         .add(TextField("body", " ".join(toks)))
                         .add(TextField("title", " ".join(rng.choice(words, 5)))))
    return flush_memory_index(mem, "_n")


def B(*clauses, ms=0):
    return BooleanQuery([BooleanClause(q, o) for q, o in clauses], ms)


def T(w, f="body"):
    return TermQuery(f, w)


PH = PhraseQuery("body", ["oil", "price"])
NESTED = {
    "should": B((PH, S), (T("trade"), S)),
    "must": B((PH, M), (T("w1"), S)),
    "must_not": B((T("trade"), S), (PH, N)),
    "filter": B((T("w2"), S), (PH, F)),
    "in_subtree": B((B((PH, S), (T("w3"), S)), M), (T("w4"), S)),
    "title_phrase": B((T("oil"), S), (PhraseQuery("title", ["w1", "w2"]), S)),
}


@pytest.fixture(scope="module")
def nested():
    seg = _nested_corpus()
    ts = IndexSearcher([segment_from_jax(seg)], device="cpu")

    def boom(query, k=None):
        raise AssertionError(f"fallback reached for {query!r}")

    ts._fallback_search = boom
    ts._fallback_count = boom
    return ts, JaxSearcher([seg]), OracleSearcher([seg])


@pytest.mark.parametrize("name", list(NESTED))
def test_phrase_clauses_in_booleans(nested, name):
    """tests/unit/test_nested_boolean.py: a phrase as SHOULD, MUST,
    MUST_NOT (and FILTER, in a subtree, on another field), served on the
    row engine without the host fallback."""
    ts, js, oracle = nested
    _four_ways(ts, js, oracle, [NESTED[name]])


EDGE = {
    "single_term": (["oil price oil", "price"], ["oil"]),
    "repeated_word": (["very very good", "very good", "good very"],
                      ["very", "very"]),
    "longer_than_docs": (["a b", "b c"], ["a", "b", "c", "d", "e"]),
}


@pytest.mark.parametrize("name", list(EDGE))
def test_query_edge_cases(name):
    """tests/unit/test_query_edge_cases.py's phrase cases."""
    texts, terms = EDGE[name]
    seg = _segment(texts)
    ts = IndexSearcher([segment_from_jax(seg)], device="cpu")
    _four_ways(ts, JaxSearcher([seg]), OracleSearcher([seg]),
               [PhraseQuery("body", terms)])


# ---------------------------------------------------------------------------
# Phrase batches on the pruned route
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch_corpus():
    """3,000 docs (D 3,072) of a 60-word vocabulary with planted bigrams."""
    rng = np.random.Generator(np.random.PCG64(8))
    words = np.asarray([f"w{i}" for i in range(60)] + ["oil", "price",
                                                       "trade", "deficit"],
                       dtype=object)
    texts = []
    for i in range(3000):
        toks = list(rng.choice(words, max(3, int(rng.normal(20, 8)))))
        if i % 5 == 0:
            toks[:2] = ["oil", "price"] if i % 2 else ["trade", "deficit"]
        texts.append(" ".join(toks))
    seg = _segment(texts, "_pb")
    ts = IndexSearcher([segment_from_jax(seg)], device="cpu")
    return seg, ts, JaxSearcher([seg]), OracleSearcher([seg])


@pytest.mark.parametrize("kind", ["phrase", "mixed"])
def test_phrase_batches_pruned(batch_corpus, kind):
    """A 64-query phrase_query_batch and a 64-query phrase_share=5 mixed
    batch, forced onto the pruned route: equal to the exhaustive route
    over the whole batch, to the JAX searcher and (on a sample) to the
    oracle; the queries equal the JAX package's batches text for text."""
    seg, ts, js, oracle = batch_corpus
    pool = tq.frequent_terms(ts, n=40)
    if kind == "phrase":
        want_q = jq.phrase_query_batch(pool, 64, seed=43)
        got_q = tq.phrase_query_batch(pool, 64, seed=43)
    else:
        want_q = jq.mixed_query_batch(pool, 64, seed=42, phrase_share=5)
        got_q = tq.mixed_query_batch(pool, 64, seed=42, phrase_share=5)
    assert [repr(q) for q in got_q] == [repr(query_from_jax(q))
                                        for q in want_q]
    assert any(isinstance(q, PhraseQuery) for q in want_q)
    (ex,) = [e for e in ts._ctx("body").row_executors if e is not None]
    ex.prune_min_docs = 0
    before = ex.metrics["pruned"].value()
    (got,) = ts.collect_many([ts.dispatch_batch(got_q, K)])
    assert ex.metrics["pruned"].value() > before, "pruned route not taken"
    plans = [ts._query_plans(q)[1][0] for q in got_q]
    pruned = ex.finalize(plans, ex.dispatch(plans, K), K)
    exhaustive = ex.finalize(plans, ex._exhaustive_chunked(plans, K), K)
    for a, b in zip(pruned, exhaustive):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b)
    want = js.search_batch(want_q, K)
    for i, (q, g, w) in enumerate(zip(want_q, got, want)):
        _same(g, w, ("vs jax", q))
        if i % 8 == 0 or isinstance(q, PhraseQuery):
            _same(g, oracle.search(q, K), ("vs oracle", q))
