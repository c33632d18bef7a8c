"""The port's MemoryIndex and flush (``diagon_tpu_torch.index``) against the
JAX package's: the cases of ``tests/unit/test_memory_index.py`` and
``tests/unit/test_bulk_ingest.py``, and the same documents, made from a
seed, flushed by both packages into segments equal in every array, dtypes
included (ASCII, non-ASCII, keyword, doc-values, point, stored and
duplicate-field documents, and fields that both the host accumulator and
the Python dicts fed). The helpers here are shared with
``test_torch_writer.py``."""

import dataclasses

import numpy as np
import pytest

import diagon_tpu.document.document as JD
import diagon_tpu_torch.document.document as TD
from diagon_tpu.index.memory_index import MemoryIndex as JMemoryIndex
from diagon_tpu.index.segment import flush_memory_index as j_flush
from diagon_tpu_torch.codecs.postings import PackedPostings
from diagon_tpu_torch.document import (
    Document,
    DoublePointField,
    LongPointField,
    NumericDocValuesField,
    StoredField,
    StringField,
    TextField,
)
from diagon_tpu_torch.index.memory_index import (
    MemoryIndex,
    decode_norm_to_length,
    encode_norm,
)
from diagon_tpu_torch.index.segment import flush_memory_index

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

VOCAB = [f"w{i}" for i in range(80)] + ["oil", "price", "Trade", "OIL"]


def corpus_spec(seed, n=300, unicode_every=0, dup_every=0, rich=True):
    """Documents as lists of (field class, name, value, kwargs), made from a
    seed; ``make_docs`` builds them in either package."""
    rng = np.random.default_rng(seed)
    spec = []
    for i in range(n):
        f = []
        body = " ".join(rng.choice(VOCAB, size=int(rng.integers(3, 30))))
        if unicode_every and i % unicode_every == 3:
            body += " café résumé Ünïcödé"  # the Python tokenizer path
        f.append(("TextField", "body", body, {}))
        f.append(("TextField", "title",
                  " ".join(rng.choice(VOCAB, size=3)), {}))
        if dup_every and i % dup_every == 5:
            f.append(("TextField", "body", "extra duplicate field text", {}))
        f.append(("StringField", "cat", f"c{int(rng.integers(0, 5))}", {}))
        f.append(("NumericDocValuesField", "rank",
                  int(rng.integers(0, 1000)), {}))
        f.append(("LongPointField", "year", int(rng.integers(1980, 2030)), {}))
        if i % 7 == 2:
            f.append(("DoublePointField", "score", float(rng.random()), {}))
        if rich:
            # keywords with UTF-8 bytes (their term order is by bytes on
            # the host and by code point in the dicts: the same order)
            kw = ["café", "cafe", "Zürich", "zz", "ça", "東京"][i % 6]
            f.append(("StringField", "place", kw, {"stored": i % 4 == 0}))
            f.append(("StoredField", "id", f"doc{i}", {}))
            f.append(("SortedDocValuesField", "color",
                      ["red", "green", "blue"][i % 3], {}))
            for v in rng.integers(0, 9, size=int(rng.integers(0, 3))):
                f.append(("SortedSetDocValuesField", "tags", f"t{v}", {}))
                f.append(("SortedNumericDocValuesField", "nums", int(v), {}))
            if i % 5 == 0:
                f.append(("BinaryDocValuesField", "blob", bytes([i % 7, 1]),
                          {}))
                f.append(("DoubleDocValuesField", "weight", i / 7.0, {}))
            if i % 9 == 4:
                f.append(("TextField", "en", "The résumés OF the oil",
                          {"analyzer": "english"}))
            if i % 11 == 6:
                f.append(("ArrayField", "labels", ["Alpha beta", "GAMMA"], {}))
            if i % 13 == 1:
                f.append(("TextField", "body2", "", {}))  # no tokens
        spec.append(f)
    return spec


def make_docs(module, spec):
    """The documents of ``spec`` as ``module``'s (a ``document.document``
    module of either package) classes."""
    docs = []
    for fields in spec:
        d = module.Document()
        for cls, name, value, kw in fields:
            d.add(getattr(module, cls)(name, value, **kw))
        docs.append(d)
    return docs


def both_docs(spec):
    return make_docs(TD, spec), make_docs(JD, spec)


def same_array(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind == "f":
        got, want = got.view(np.uint8), want.view(np.uint8)
    assert np.array_equal(got, want), what


def assert_field_infos_equal(got, want):
    if want is None:
        assert got is None
        return
    assert [fi.name for fi in got] == [fi.name for fi in want]
    for g, w in zip(got, want):
        assert (g.index_options.name, g.doc_values_type.name, g.point_dims,
                g.point_double, g.analyzer) == (
            w.index_options.name, w.doc_values_type.name, w.point_dims,
            w.point_double, w.analyzer), g.name


def assert_segments_equal(got, want, infos=True):
    """A port segment equal to a JAX one (or to another port one): every
    postings array (positions after ``ensure_positions``), the norms, doc
    values, points, stored rows, live docs and, with ``infos``, the field
    infos; dtypes included."""
    assert got.num_docs == want.num_docs
    assert list(got.fields) == list(want.fields)
    for name, fd in want.fields.items():
        gf = got.fields[name]
        assert gf.with_positions == fd.with_positions, name
        same_array(f"{name} norms", gf.norms, fd.norms)
        gp, wp = gf.postings, fd.postings
        gp.ensure_positions()
        wp.ensure_positions()
        for f in dataclasses.fields(PackedPostings):
            if f.name == "pos_loader":
                continue
            a, b = getattr(gp, f.name), getattr(wp, f.name)
            if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                same_array(f"{name} {f.name}", a, b)
            else:
                assert a == b, (name, f.name, a, b)
    assert list(got.doc_values) == list(want.doc_values)
    for name, dv in want.doc_values.items():
        g = got.doc_values[name]
        assert g.dv_type.name == dv.dv_type.name, name
        same_array(f"{name} dv docs", g.docs, dv.docs)
        same_array(f"{name} dv values", g.values, dv.values)
        assert g.ord_values == dv.ord_values, name
        if dv.value_start is None:
            assert g.value_start is None, name
        else:
            same_array(f"{name} value_start", g.value_start, dv.value_start)
    assert list(got.points) == list(want.points)
    for name, pt in want.points.items():
        g = got.points[name]
        same_array(f"{name} point values", g.values, pt.values)
        same_array(f"{name} point docs", g.docs, pt.docs)
        assert g.is_double == pt.is_double
    assert list(got.stored) == list(want.stored)
    if want.live_docs is None:
        assert got.live_docs is None
    else:
        same_array("live_docs", got.live_docs, want.live_docs)
    if infos:
        assert_field_infos_equal(got.field_infos, want.field_infos)


def flush_both(spec, bulk=False, name="_a"):
    tdocs, jdocs = both_docs(spec)
    tm, jm = MemoryIndex(), JMemoryIndex()
    if bulk:
        assert tm.add_documents(tdocs) == jm.add_documents(jdocs)
    else:
        for t, j in zip(tdocs, jdocs):
            assert tm.add_document(t) == jm.add_document(j)
    assert tm.ram_bytes_used() == jm.ram_bytes_used()
    return flush_memory_index(tm, name), j_flush(jm, name)


# ---------------------------------------------------------------------------
# tests/unit/test_memory_index.py
# ---------------------------------------------------------------------------


def test_encode_norm_reference_values():
    # DocumentsWriterPerThread.cpp:462-484
    assert encode_norm(0) == 127
    assert encode_norm(1) == 127
    assert encode_norm(2) == 89  # int(127/sqrt(2)) = int(89.80) = 89
    assert encode_norm(4) == 63
    assert encode_norm(100) == 12
    assert encode_norm(10000) == 1
    assert encode_norm(1000000) == 0
    from diagon_tpu.index.memory_index import (
        decode_norm_to_length as j_decode,
        encode_norm as j_encode,
    )

    for n in range(0, 3000, 7):
        assert encode_norm(n) == j_encode(n)
    for b in range(128):
        assert decode_norm_to_length(b) == j_decode(b)


def test_add_and_flush_basic():
    mem = MemoryIndex()
    mem.add_document(
        Document()
        .add(TextField("body", "oil price rises as oil supply falls"))
        .add(StringField("tag", "energy"))
        .add(NumericDocValuesField("views", 42))
        .add(LongPointField("ts", 1000))
        .add(StoredField("id", "doc0"))
    )
    mem.add_document(
        Document()
        .add(TextField("body", "trade deficit widens"))
        .add(NumericDocValuesField("views", 7))
        .add(LongPointField("ts", 2000))
        .add(StoredField("id", "doc1"))
    )

    seg = flush_memory_index(mem, "_0")
    assert seg.num_docs == 2

    body = seg.fields["body"].postings
    tid = body.term_id("oil")
    assert tid >= 0
    assert body.doc_freq[tid] == 1
    assert body.total_tf[tid] == 2  # "oil" twice in doc 0

    # norms: doc0 body length 7, doc1 length 3
    norms = seg.fields["body"].norms
    assert norms[0] == encode_norm(7)
    assert norms[1] == encode_norm(3)

    # keyword field: untokenized
    tag = seg.fields["tag"].postings
    assert tag.term_id("energy") >= 0

    # doc values + points + stored
    dv = seg.doc_values["views"]
    np.testing.assert_array_equal(dv.docs, [0, 1])
    np.testing.assert_array_equal(dv.values, [42, 7])
    pt = seg.points["ts"]
    np.testing.assert_array_equal(pt.values, [1000, 2000])
    assert seg.stored[0]["id"] == "doc0"
    assert seg.stored[1]["id"] == "doc1"


def test_positions_recorded():
    mem = MemoryIndex()
    mem.add_document(Document().add(TextField("body", "a b a c a")))
    seg = flush_memory_index(mem, "_0")
    pp = seg.fields["body"].postings
    tid = pp.term_id("a")
    b = int(pp.block_start[tid])
    e0 = int(pp.block_entry_start[b])
    s, e = int(pp.pos_start[e0]), int(pp.pos_start[e0 + 1])
    np.testing.assert_array_equal(pp.positions[s:e], [0, 2, 4])


def test_collection_stats():
    mem = MemoryIndex()
    mem.add_document(Document().add(TextField("body", "x y z")))
    mem.add_document(Document().add(TextField("body", "x x")))
    mem.add_document(Document().add(TextField("other", "q")))
    seg = flush_memory_index(mem, "_0")
    pp = seg.fields["body"].postings
    assert pp.sum_total_tf == 5
    assert pp.sum_doc_freq == 4  # x:2 docs, y:1, z:1
    assert pp.doc_count_with_field == 2


def test_empty_flush():
    assert flush_memory_index(MemoryIndex(), "_0") is None


def test_deletes():
    mem = MemoryIndex()
    for i in range(4):
        mem.add_document(Document().add(TextField("body", f"doc {i}")))
    seg = flush_memory_index(mem, "_0")
    assert seg.num_live_docs == 4
    assert seg.delete_document(2)
    assert not seg.delete_document(2)  # already deleted
    assert seg.num_live_docs == 3


# ---------------------------------------------------------------------------
# tests/unit/test_bulk_ingest.py
# ---------------------------------------------------------------------------


def _corpus(rng_seed, n=300, unicode_every=0, dup_every=0):
    return make_docs(TD, corpus_spec(rng_seed, n, unicode_every, dup_every,
                                     rich=False))


@pytest.mark.parametrize("unicode_every,dup_every", [
    (0, 0),     # pure host bulk
    (11, 0),    # python-tokenizer docs split the batch into runs
    (0, 13),    # duplicate-field docs fall back per-doc
    (9, 13),    # both
])
def test_bulk_matches_per_doc(unicode_every, dup_every):
    docs = _corpus(42, 300, unicode_every, dup_every)

    m1 = MemoryIndex()
    for d in docs:
        m1.add_document(d)
    seg1 = flush_memory_index(m1, "_a")

    m2 = MemoryIndex()
    first = m2.add_documents(docs)
    assert first == 0
    seg2 = flush_memory_index(m2, "_a")

    assert_segments_equal(seg1, seg2)


def test_bulk_appends_after_per_doc():
    docs = _corpus(7, 60)
    m1, m2 = MemoryIndex(), MemoryIndex()
    for d in docs[:20]:
        m1.add_document(d)
        m2.add_document(d)
    for d in docs[20:]:
        m1.add_document(d)
    assert m2.add_documents(docs[20:]) == 20
    assert_segments_equal(
        flush_memory_index(m1, "_a"), flush_memory_index(m2, "_a")
    )


def test_writer_add_documents_roundtrip(tmp_path):
    from diagon_tpu_torch.index.reader import DirectoryReader
    from diagon_tpu_torch.index.writer import IndexWriter
    from diagon_tpu_torch.search import IndexSearcher, TermQuery
    from diagon_tpu_torch.store import FSDirectory

    d = FSDirectory(str(tmp_path))
    w = IndexWriter(d)
    docs = [
        Document()
        .add(TextField("body", f"oil price doc{i}"))
        .add(StringField("cat", f"c{i % 3}"))
        for i in range(200)
    ]
    w.add_documents(docs)
    w.commit()
    r = DirectoryReader.open(d)
    s = IndexSearcher(r.leaves(), device="cpu")
    assert s.search(TermQuery("body", "oil"), 10).total_hits == 200
    assert s.search(TermQuery("cat", "c1"), 10).total_hits == 67
    w.close()


# ---------------------------------------------------------------------------
# the same documents through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bulk", [False, True], ids=["per_doc", "bulk"])
@pytest.mark.parametrize("unicode_every,dup_every", [(0, 0), (4, 0), (0, 6),
                                                     (5, 6)])
def test_flush_equals_jax(bulk, unicode_every, dup_every):
    """ASCII, non-ASCII, keyword (UTF-8 ones too), every doc-values type,
    points, stored, analyzers, array and duplicate-field documents: the
    port's segment equals the JAX package's in every array, dtypes and
    field infos included, and the RAM accounting agrees."""
    spec = corpus_spec(5 + unicode_every, 240, unicode_every, dup_every)
    got, want = flush_both(spec, bulk=bulk)
    assert_segments_equal(got, want)


def test_mixed_field_takes_the_third_branch():
    """A text field that saw ASCII docs (host accumulator) and non-ASCII
    docs (Python dicts), with doc-level overlap from duplicate fields, and
    a keyword field that the bulk batch and the per-doc path both fed:
    both flush through the per-term merge and the dict packer, equal to
    the JAX package."""
    spec = corpus_spec(11, 200, unicode_every=4, dup_every=5)
    tdocs, jdocs = both_docs(spec)
    tm, jm = MemoryIndex(), JMemoryIndex()
    tm.add_documents(tdocs)
    jm.add_documents(jdocs)
    fb = tm.fields["body"]
    assert fb.native is not None and fb.postings  # both buffers
    assert tm.fields["place"].native is not None and tm.fields["place"].postings
    assert_segments_equal(flush_memory_index(tm, "_m"), j_flush(jm, "_m"))


def test_non_ascii_keyword_term_order():
    """UTF-8 keywords sort by their bytes on the host and by code point in
    the dicts; both are the JAX package's order."""
    values = ["zz", "café", "cafe", "Zürich", "ça", "東京", "a", "é"]
    spec = [[("StringField", "k", v, {})] for v in values]
    for bulk in (False, True):
        got, want = flush_both(spec, bulk=bulk)
        assert got.fields["k"].postings.terms == sorted(values)
        assert_segments_equal(got, want)


def test_ram_accounting_matches_jax_per_doc():
    """``ram_bytes_used`` after every document equals the JAX package's
    (the flush points of a ``ram_buffer_mb`` writer depend on it)."""
    spec = corpus_spec(21, 120, unicode_every=5, dup_every=7)
    tdocs, jdocs = both_docs(spec)
    tm, jm = MemoryIndex(), JMemoryIndex()
    for t, j in zip(tdocs, jdocs):
        tm.add_document(t)
        jm.add_document(j)
        assert tm.ram_bytes_used() == jm.ram_bytes_used()
    tm.add_documents(tdocs)
    jm.add_documents(jdocs)
    assert tm.ram_bytes_used() == jm.ram_bytes_used()


@pytest.mark.parametrize("ram_mb,bulk", [(0.02, False), (0.05, False),
                                         (0.02, True)])
def test_ram_buffer_flush_points_match_jax(ram_mb, bulk):
    """Trap 1: writers with the same ``ram_buffer_mb`` cut their segments
    at the same documents as the JAX writer, and the segments are equal."""
    from diagon_tpu.index.writer import IndexWriter as JW, IndexWriterConfig as JC
    from diagon_tpu.store import RAMDirectory as JR
    from diagon_tpu_torch.index.writer import IndexWriter, IndexWriterConfig
    from diagon_tpu_torch.store import RAMDirectory

    spec = corpus_spec(31, 300, unicode_every=7)
    tdocs, jdocs = both_docs(spec)
    tw = IndexWriter(RAMDirectory(), IndexWriterConfig(
        ram_buffer_mb=ram_mb, merge_scheduler="serial"))
    jw = JW(JR(), JC(ram_buffer_mb=ram_mb, merge_scheduler="serial"))
    if bulk:
        for i in range(0, 300, 25):
            tw.add_documents(tdocs[i:i + 25])
            jw.add_documents(jdocs[i:i + 25])
    else:
        for t, j in zip(tdocs, jdocs):
            tw.add_document(t)
            jw.add_document(j)
    sizes = [s.num_docs for s in tw._segments]
    assert sizes == [s.num_docs for s in jw._segments]
    assert len(sizes) >= 2
    for g, w in zip(tw._segments, jw._segments):
        assert_segments_equal(g, w)
    tw.close()
    jw.close()


@pytest.mark.parametrize("mapped", [False, True], ids=["untyped", "mapping"])
def test_json_documents_equal_jax(mapped):
    """JSON documents through each package's JsonDocumentParser (untyped,
    and with an IndexMapping of text, keyword, numeric and array fields)
    flush into equal segments; a mapping refuses an undeclared array."""
    import json

    from diagon_tpu.document import (
        IndexMapping as JMap,
        JsonDocumentParser as JParser,
    )
    from diagon_tpu_torch.document import IndexMapping, JsonDocumentParser

    rng = np.random.default_rng(3)
    rows = []
    for i in range(150):
        rows.append(json.dumps({
            "title": " ".join(rng.choice(VOCAB, 4)),
            "tag": f"t{i % 4}",
            "views": int(rng.integers(0, 500)),
            "score": float(rng.random()),
            "flag": bool(i % 2),
            "labels": [f"L{j}" for j in range(i % 3)],
            "meta": {"a": i},
            "none": None,
        }))

    def mapping(cls):
        if not mapped:
            return None
        return (cls().text("title", stored=True).keyword("tag", stored=True)
                .numeric("views").array("labels"))

    tp, jp = JsonDocumentParser(mapping(IndexMapping)), JParser(mapping(JMap))
    tm, jm = MemoryIndex(), JMemoryIndex()
    tm.add_documents([tp.parse(r) for r in rows])
    jm.add_documents([jp.parse(r) for r in rows])
    assert_segments_equal(flush_memory_index(tm, "_j"), j_flush(jm, "_j"))
    if mapped:
        with pytest.raises(ValueError):
            tp.parse('{"tag": ["a", "b"]}')
