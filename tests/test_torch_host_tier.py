"""The port's own host tier against the JAX package's originals, on the same
inputs: BM25 (bit for bit), the query classes through ``query_from_jax``,
the oracle (on the corpora of ``tests/unit/test_oracle.py``, ranges and
pure MUST_NOT included), the posting packer and its decoder, the host C++
of ``csrc/host/bulk.cpp`` against ``diagon_tpu/native``, the synthetic
segment builder, and the metrics registry."""

import numpy as np
import pytest

from diagon_tpu.bench import bulk_build as jbulk
from diagon_tpu.bench import queries as jqueries
from diagon_tpu.codecs import postings as jpost
from diagon_tpu.document import (
    Document,
    DoubleDocValuesField,
    LongPointField,
    NumericDocValuesField,
    SortedNumericDocValuesField,
    TextField,
)
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.observability.metrics import registry as jregistry
from diagon_tpu.search import query as jq
from diagon_tpu.search.bm25 import BM25Similarity as JaxBM25
from diagon_tpu.search.oracle import OracleSearcher as JaxOracle
from diagon_tpu.search.topdocs import ScoreDoc as JSD
from diagon_tpu.search.topdocs import TopDocs as JTD
from diagon_tpu.search.topdocs import merge_top_docs as jmerge
from diagon_tpu_torch import native
from diagon_tpu_torch.bench import bulk_build, queries
from diagon_tpu_torch.codecs import postings
from diagon_tpu_torch.observability.metrics import registry
from diagon_tpu_torch.search import query as pq
from diagon_tpu_torch.search.bm25 import BM25Similarity
from diagon_tpu_torch.search.convert import query_from_jax, segment_from_jax
from diagon_tpu_torch.search.oracle import OracleSearcher
from diagon_tpu_torch.search.topdocs import ScoreDoc, TopDocs, merge_top_docs


@pytest.fixture(scope="module", autouse=True)
def jnative(tmp_path_factory):
    """The JAX package's C++ extension, built by its own ``_build`` into a
    directory of this worker's own and loaded from there, and set as the
    JAX package's ``_native`` for this module's tests. On import the
    package builds it unlocked into its own directory, so parallel test
    workers can load a half-written library and fall back to None. A build
    that fails fails the tests."""
    import importlib.util
    import os

    import diagon_tpu.native as jmod

    so = tmp_path_factory.mktemp("jax_native") / os.path.basename(
        jmod._so_path())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "_so_path", lambda: str(so))
        assert jmod._build(), "the JAX package's extension did not build"
        spec = importlib.util.spec_from_file_location(
            "diagon_tpu.native._native", str(so))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mp.setattr(jmod, "_native", mod)
        yield mod


def _u32(x):
    return np.asarray(x, np.float32).view(np.uint32)


# ---------------------------------------------------------------- BM25


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bm25_idf_and_scores_bit_equal(seed):
    rng = np.random.default_rng(seed)
    port, jax_ = BM25Similarity(), JaxBM25()
    doc_count = int(rng.integers(10, 10_000_000))
    for df in rng.integers(1, doc_count, 50):
        assert _u32(port.idf(int(df), doc_count)) == _u32(jax_.idf(int(df), doc_count))
    for stt in (0, 1, int(rng.integers(1, 1 << 40))):
        assert _u32(BM25Similarity.avg_field_length(stt, doc_count)) == _u32(
            JaxBM25.avg_field_length(stt, doc_count))
    idf = port.idf(37, doc_count)
    avgdl = np.float32(rng.random() * 200 + 1)
    freqs = rng.integers(0, 300, 4096).astype(np.float32)
    norms = rng.integers(0, 128, 4096)
    np.testing.assert_array_equal(
        _u32(port.scorer(idf, avgdl).score(freqs, norms)),
        _u32(jax_.scorer(idf, avgdl).score(freqs, norms)))
    np.testing.assert_array_equal(
        _u32(BM25Similarity.decode_norm_length(norms)),
        _u32(JaxBM25.decode_norm_length(norms)))


# ---------------------------------------------------------------- queries


def _jax_queries():
    B = jq.BooleanQuery
    C = jq.BooleanClause
    T = jq.TermQuery
    return {
        "term": T("body", "oil"),
        "term_boosted": T("body", "oil", boost=2.5),
        "boolean": B([C(T("body", "oil"), jq.Occur.MUST),
                      C(T("body", "gas"), jq.Occur.SHOULD),
                      C(T("body", "tax"), jq.Occur.FILTER),
                      C(T("body", "war"), jq.Occur.MUST_NOT)], 1, boost=1.5),
        "nested": B([C(B([C(T("body", "a"), jq.Occur.SHOULD)]), jq.Occur.MUST),
                     C(jq.PhraseQuery("body", ["a", "b"]), jq.Occur.SHOULD)]),
        "phrase": jq.PhraseQuery("body", ["oil", "price"], boost=0.5),
        "match_all": jq.MatchAllDocsQuery(),
        "numeric_range": jq.NumericRangeQuery("num", 10, None),
        "point_range": jq.PointRangeQuery("pt", None, 300),
        "double_range": jq.DoubleRangeQuery("dbl", 0.5, 2.5, False, True),
        "double_upper": jq.DoubleRangeQuery.new_upper_bound_query("dbl", 1.0),
    }


def _attrs(q):
    """A query's content as plain values, clauses recursively."""
    out = {"class": type(q).__name__, "boost": q.boost}
    for name, v in sorted(vars(q).items()):
        if name == "clauses":
            v = [(_attrs(c.query), c.occur.name) for c in v]
        elif name == "term":
            v = (v.field, v.text)
        out[name] = v
    return out


@pytest.mark.parametrize("name", list(_jax_queries()))
def test_query_from_jax_round_trips(name):
    jquery = _jax_queries()[name]
    port = query_from_jax(jquery)
    assert isinstance(port, pq.Query)
    assert type(port) is getattr(pq, type(jquery).__name__)
    assert _attrs(port) == _attrs(jquery)
    assert repr(port) == repr(jquery)
    assert _attrs(query_from_jax(port)) == _attrs(port)  # idempotent
    if isinstance(port, pq.BooleanQuery):
        for c in port.clauses:
            assert isinstance(c, pq.BooleanClause)
            assert isinstance(c.query, pq.Query)
            assert isinstance(c.occur, pq.Occur)


def test_query_from_jax_rejects_unknown_classes():
    class Foreign:
        boost = 1.0

    with pytest.raises(TypeError):
        query_from_jax(Foreign())


def test_builders_and_split():
    b = pq.BooleanQuery.Builder()
    b.add(pq.TermQuery("body", "a"), pq.Occur.MUST)
    b.add(pq.TermQuery("body", "b"), pq.Occur.SHOULD)
    q = b.set_minimum_number_should_match(1).build()
    must, should, filt, must_not = q.split()
    assert len(must) == len(should) == 1 and not filt and not must_not
    assert q.minimum_number_should_match == 1
    assert pq.PhraseQuery.Builder("body").add("a").add("b").build().terms == ["a", "b"]


def test_topdocs_merge_equal():
    parts = [[(3, 1.5), (0, 2.0)], [(7, 2.0), (9, 0.5)], []]
    port = merge_top_docs([TopDocs(len(p), [ScoreDoc(d, s) for d, s in p])
                           for p in parts], 3)
    jax_ = jmerge([JTD(len(p), [JSD(d, s) for d, s in p]) for p in parts], 3)
    assert port.total_hits == jax_.total_hits
    assert port.doc_ids() == jax_.doc_ids() and port.scores() == jax_.scores()


# ---------------------------------------------------------------- oracle


def _build(docs_text, name="_0"):
    mem = MemoryIndex()
    for t in docs_text:
        mem.add_document(Document().add(TextField("body", t)))
    return flush_memory_index(mem, name)


def _ranges_segment():
    mem = MemoryIndex()
    for i, t in enumerate(["a", "b", "c", "d", "a b", "c a"]):
        mem.add_document(
            Document()
            .add(TextField("body", t))
            .add(NumericDocValuesField("num", i * 10))
            .add(LongPointField("pt", i * 100))
            .add(DoubleDocValuesField("dbl", i * 0.5))
            .add(SortedNumericDocValuesField("multi", i))
            .add(SortedNumericDocValuesField("multi", 10 - i))
        )
    return flush_memory_index(mem, "_r")


def _corpora():
    """(segments, queries): the corpora and queries of test_oracle.py, plus
    ranges inside booleans, pure MUST_NOT, deletes and multiple segments."""
    T, B, C, O = jq.TermQuery, jq.BooleanQuery, jq.BooleanClause, jq.Occur

    def bq(*cl, ms=0):
        return B([C(q, o) for q, o in cl], ms)

    deleted = _build(["oil price", "oil gas", "price water", "oil oil"], "_d")
    deleted.delete_document(1)
    rng = _ranges_segment()
    return [
        ([_build(["oil price oil", "trade surplus report", "oil exports"])],
         [T("body", "oil"), T("body", "trade", boost=3.0)]),
        ([_build(["oil price", "oil", "price oil cheap", "gas price"])],
         [bq((T("body", "oil"), O.MUST), (T("body", "price"), O.MUST))]),
        ([_build(["a b", "a", "b", "c"])],
         [bq((T("body", "a"), O.SHOULD), (T("body", "b"), O.SHOULD)),
          bq((T("body", "a"), O.SHOULD), (T("body", "b"), O.SHOULD), ms=2)]),
        ([_build(["oil price", "oil gas", "price water"]), deleted],
         [bq((T("body", "oil"), O.MUST), (T("body", "gas"), O.MUST_NOT)),
          bq((T("body", "price"), O.SHOULD), (T("body", "oil"), O.FILTER)),
          bq((T("body", "oil"), O.MUST_NOT)),  # pure MUST_NOT
          T("body", "oil")]),
        ([_build(["the oil price rose", "oil and price", "price oil",
                  "big oil price oil price"])],
         [jq.PhraseQuery("body", ["oil", "price"])]),
        ([_build(["federal reserve bank cut rates", "federal bank reserve"])],
         [jq.PhraseQuery("body", ["federal", "reserve", "bank"])]),
        ([rng],
         [jq.MatchAllDocsQuery(),
          jq.NumericRangeQuery("num", lower=10, upper=20),
          jq.PointRangeQuery("pt", lower=150, upper=None),
          jq.DoubleRangeQuery("dbl", 0.5, 2.0, include_lower=False),
          jq.NumericRangeQuery("multi", 3, 4),
          bq((T("body", "a"), O.MUST), (jq.NumericRangeQuery("num", 0, 30), O.FILTER)),
          bq((T("body", "a"), O.SHOULD), (jq.PointRangeQuery("pt", 400, None), O.MUST_NOT)),
          bq((jq.NumericRangeQuery("num", 0, 100), O.MUST_NOT))]),
        ([_build(["same text", "same text", "same text"])],
         [T("body", "same")]),
        ([_build(["oil price", "water"]), _build(["deep oil"], "_1")],
         [T("body", "oil")]),
    ]


def _same_topdocs(a, b):
    assert a.total_hits == b.total_hits
    assert a.doc_ids() == b.doc_ids()
    np.testing.assert_array_equal(_u32(a.scores()), _u32(b.scores()))


@pytest.mark.parametrize("case", range(9))
def test_oracle_equals_jax_oracle(case):
    segs, qs = _corpora()[case]
    port = OracleSearcher([segment_from_jax(s) for s in segs])
    jax_ = JaxOracle(segs)
    for q in qs:
        for k in (1, 2, 10):
            _same_topdocs(port.search(query_from_jax(q), k), jax_.search(q, k))
        assert port.count(query_from_jax(q)) == jax_.count(q)


def test_range_masks_equal_jax():
    from diagon_tpu.search import oracle as jo
    from diagon_tpu_torch.search import oracle as po

    jseg = _ranges_segment()
    seg = segment_from_jax(jseg)
    for lo, hi in ((None, None), (10, 20), (None, 15), (25, None), (3, 4)):
        for field in ("num", "multi", "absent"):
            np.testing.assert_array_equal(po.numeric_range_mask(seg, field, lo, hi),
                                          jo.numeric_range_mask(jseg, field, lo, hi))
        np.testing.assert_array_equal(
            po.point_range_mask(seg, "pt", lo and lo * 10, hi and hi * 10),
            jo.point_range_mask(jseg, "pt", lo and lo * 10, hi and hi * 10))
    for inc_lo in (True, False):
        for inc_hi in (True, False):
            np.testing.assert_array_equal(
                po.double_range_mask(seg, "dbl", 0.5, 2.0, inc_lo, inc_hi),
                jo.double_range_mask(jseg, "dbl", 0.5, 2.0, inc_lo, inc_hi))


# ---------------------------------------------------------------- postings


def _csr(seed, T=40, D=5000):
    rng = np.random.default_rng(seed)
    df = rng.integers(1, 700, T)
    df[::7] = rng.integers(129, 400, len(df[::7]))  # multi-block terms
    entry_start = np.concatenate([[0], np.cumsum(df)]).astype(np.int64)
    docs = np.concatenate([np.sort(rng.choice(D, d, replace=False)) for d in df])
    freqs = np.where(rng.random(len(docs)) < 0.6, 1,
                     rng.integers(1, 200, len(docs)))
    freqs[: df[0]] = 1  # an all-freq-1 term
    norms = rng.integers(1, 128, D).astype(np.uint8)
    terms = [f"t{i:03d}" for i in range(T)]
    return terms, entry_start, docs.astype(np.int32), freqs.astype(np.int32), norms


COLUMNS = ("block_start", "doc_freq", "total_tf", "block_term", "block_base",
           "block_count", "block_doc_bits", "block_freq_bits", "block_word_off",
           "block_max_freq", "block_max_norm", "block_entry_start", "packed")


@pytest.mark.parametrize("with_norms", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_packed_postings_and_decode_equal_jax(seed, with_norms):
    terms, es, docs, freqs, norms = _csr(seed)
    norms = norms if with_norms else None
    port = postings.build_packed_postings_csr(terms, es, docs, freqs, norms=norms)
    jax_ = jpost.build_packed_postings_csr(terms, es, docs, freqs, norms=norms)
    for name in COLUMNS:
        a, b = getattr(port, name), getattr(jax_, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("terms", "sum_total_tf", "sum_doc_freq", "max_window_words"):
        assert getattr(port, name) == getattr(jax_, name), name
    for b in range(0, port.num_blocks, 3):
        for x, y in zip(postings.decode_block_numpy(port, b),
                        jpost.decode_block_numpy(jax_, b)):
            np.testing.assert_array_equal(x, y)
    assert port.term_id("t007") == jax_.term_id("t007") == 7
    assert port.term_id("zzz") == -1


def test_empty_postings_equal_jax():
    port = postings.build_packed_postings_csr([], np.zeros(1, np.int64),
                                              np.zeros(0), np.zeros(0))
    jax_ = jpost.build_packed_postings_csr([], np.zeros(1, np.int64),
                                           np.zeros(0), np.zeros(0))
    for name in COLUMNS:
        np.testing.assert_array_equal(getattr(port, name), getattr(jax_, name))


def _token_stream(seed):
    probs = 1.0 / np.power(np.arange(300) + 2.7, 1.07)
    probs /= probs.sum()
    pflat = np.asarray([5, 9, 1, 2, 3], np.int32)
    pstart = np.asarray([0, 2, 5], np.int32)
    remap = np.random.default_rng(seed).permutation(300).astype(np.int32)
    return probs, pflat, pstart, remap


@pytest.mark.parametrize("len_kind", [0, 1])
def test_host_synth_and_invert_equal_native(len_kind, jnative):
    probs, pflat, pstart, remap = _token_stream(len_kind)
    a, b = (np.log(40.0), 0.7) if len_kind == 0 else (3.0, 9.0)
    dl, tok = native.synth_tokens(700, 99, probs, len_kind, a, b, 3, pflat,
                                  pstart, 0.3, remap)
    dl_b, tok_b = jnative.synth_tokens(
        700, 99, probs.tobytes(), len_kind, a, b, 3, pflat.tobytes(),
        pstart.tobytes(), 0.3, remap.tobytes())
    assert dl.tobytes() == dl_b and tok.tobytes() == tok_b
    for with_pos in (True, False):
        es, docs, freqs, pos = native.invert_tokens(dl, tok, 300, with_pos)
        want = jnative.invert_tokens(dl.tobytes(), tok.tobytes(), 300, with_pos)
        assert es.tobytes() == want[0]
        assert docs.tobytes() == want[1] and freqs.tobytes() == want[2]
        assert (pos.tobytes() if with_pos else b"") == want[3]


def test_host_pack_blocks_equals_native(jnative):
    terms, es, docs, freqs, norms = _csr(3)
    got = native.pack_blocks(es, docs, freqs, norms)
    want = jnative.pack_blocks(es.tobytes(), docs.tobytes(), freqs.tobytes(),
                               norms.tobytes())
    names = ("block_start", "block_term", "block_base", "block_count",
             "block_doc_bits", "block_freq_bits", "block_word_off",
             "block_max_freq", "block_max_norm", "block_entry_start", "packed")
    for name, w in zip(names, want[:11]):
        assert got[name].tobytes() == w, name
    assert got["max_window"] == want[11]
    assert got["doc_freq"].tobytes() == want[12]
    assert got["total_tf"].tobytes() == want[13]


def test_host_library_rejects_bad_csr():
    terms, es, docs, freqs, norms = _csr(4)
    with pytest.raises(ValueError):
        native.pack_blocks(es[:-1], docs, freqs, norms)
    with pytest.raises(ValueError):
        native.invert_tokens(np.asarray([2, 2], np.int32),
                             np.asarray([0, 1, 2], np.int32), 3, False)


# ---------------------------------------------------------------- bench


def test_synthetic_segment_equals_jax_builder():
    """Same seed, same segment: the port's host C++ is built without
    -march=native and with -ffp-contract=off, the JAX package's with
    -march=native, and the token streams still agree here (the one
    contractible expression, len_a + len_b * z in the lognormal length,
    rounds the same on these inputs)."""
    port = bulk_build.build_synthetic_segment(2_000)
    jax_ = jbulk.build_synthetic_segment(2_000)
    assert port.num_docs == jax_.num_docs
    assert sorted(port.fields) == sorted(jax_.fields) == ["body", "date", "title"]
    for name in port.fields:
        a, b = port.fields[name], jax_.fields[name]
        np.testing.assert_array_equal(a.norms, b.norms)
        assert a.with_positions == b.with_positions
        pa, pb = a.postings, b.postings
        for col in COLUMNS + ("pos_start", "positions"):
            x, y = getattr(pa, col), getattr(pb, col)
            assert (x is None) == (y is None), (name, col)
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{col}")
        for attr in ("terms", "sum_total_tf", "sum_doc_freq",
                     "doc_count_with_field", "max_window_words"):
            assert getattr(pa, attr) == getattr(pb, attr), (name, attr)


def test_benchmark_queries_equal_jax():
    port = queries.reuters_queries()
    jax_ = jqueries.reuters_queries()
    assert list(port) == list(jax_)
    for name in port:
        assert repr(port[name]) == repr(jax_[name])
    pool = [f"w{i}" for i in range(32)]
    got = queries.mixed_query_batch(pool, 300)
    want = jqueries.mixed_query_batch(pool, 300)
    assert [repr(q) for q in got] == [repr(q) for q in want]


def test_metrics_registry_is_the_ports_own():
    c = registry.counter("search.escalations")
    assert c is not jregistry.counter("search.escalations")
    before = c.value()
    c.increment(3)
    assert c.value() == before + 3
    assert registry.snapshot()["search.escalations"] == before + 3
