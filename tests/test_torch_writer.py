"""The port's IndexWriter, merges and packers against the JAX package's: the
cases of ``tests/unit/test_writer.py``, ``tests/unit/test_merge_policy.py``
and ``tests/unit/test_csr_packer.py`` on the port, then the same documents
through both writers: equal segments, byte-equal files that each package
reads from the other, equal merges with deletes, a merged index that
serves the oracle's answers, and the reopened-append merge that the JAX
merger cannot do (its positions are still lazy; the port loads them)."""

import sys
import threading
import warnings

import numpy as np
import pytest

from diagon_tpu_torch.document import Document, StoredField, TextField
from diagon_tpu_torch.document.document import Document as TDocument
from diagon_tpu_torch.index.memory_index import MemoryIndex
from diagon_tpu_torch.index.merge import (
    SegmentMerger,
    TieredMergePolicy,
    segment_size_bytes,
)
from diagon_tpu_torch.index.reader import DirectoryReader
from diagon_tpu_torch.index.segment import flush_memory_index
from diagon_tpu_torch.index.writer import (
    IndexWriter,
    IndexWriterConfig,
    find_latest_commit_gen,
)
from diagon_tpu_torch.search.oracle import OracleSearcher
from diagon_tpu_torch.search.query import TermQuery
from diagon_tpu_torch.store import FSDirectory, LockObtainFailedError

from test_torch_memory_index import (
    assert_segments_equal,
    both_docs,
    corpus_spec,
    same_array,
)


def _doc(text, doc_id=None):
    d = Document().add(TextField("body", text))
    if doc_id is not None:
        d.add(StoredField("id", doc_id))
    return d


def _search(reader, term, k=10):
    return OracleSearcher(reader.segments_data()).search(
        TermQuery("body", term), k
    )


# ---------------------------------------------------------------------------
# tests/unit/test_writer.py
# ---------------------------------------------------------------------------


def test_add_commit_reopen(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("oil price", "a"))
        w.add_document(_doc("trade news", "b"))
        gen = w.commit()
        assert gen >= 1

    r = DirectoryReader.open(d)
    assert r.max_doc() == 2
    assert _search(r, "oil").doc_ids() == [0]
    assert r.document(0) == {"id": "a"}
    assert r.document(1) == {"id": "b"}


def test_single_writer_lock(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    w = IndexWriter(d)
    with pytest.raises(LockObtainFailedError):
        IndexWriter(d)
    w.close()
    IndexWriter(d).close()


def test_multi_flush_segments_and_force_merge(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    cfg = IndexWriterConfig(max_buffered_docs=2, merge_scheduler="serial")
    with IndexWriter(d, cfg) as w:
        for i in range(7):
            w.add_document(_doc(f"doc number w{i} oil", str(i)))
        w.flush()
        assert w.segment_count >= 3
        w.force_merge(1)
        assert w.segment_count == 1
        w.commit()

    r = DirectoryReader.open(d)
    assert r.max_doc() == 7
    assert len(r.leaves()) == 1
    td = _search(r, "oil")
    assert td.total_hits == 7
    # stored fields survive merge in docid order
    assert [r.document(i)["id"] for i in range(7)] == [str(i) for i in range(7)]


def test_merge_preserves_scores(tmp_path):
    """Multi-segment scores == single merged segment scores (same stats)."""
    d1 = FSDirectory(tmp_path / "multi")
    texts = [f"oil price w{i} {'extra words ' * (i % 3)}" for i in range(20)]
    cfg = IndexWriterConfig(max_buffered_docs=4, merge_scheduler="serial")
    with IndexWriter(d1, cfg) as w:
        for t in texts:
            w.add_document(_doc(t))
        w.commit()
    r1 = DirectoryReader.open(d1)
    before = _search(r1, "oil")

    d2 = FSDirectory(tmp_path / "merged")
    with IndexWriter(d2, cfg) as w:
        for t in texts:
            w.add_document(_doc(t))
        w.force_merge(1)
        w.commit()
    r2 = DirectoryReader.open(d2)
    after = _search(r2, "oil")

    assert before.doc_ids() == after.doc_ids()
    assert [s.score for s in before.score_docs] == [
        s.score for s in after.score_docs
    ]


def test_delete_documents(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("oil alpha"))
        w.add_document(_doc("oil beta"))
        w.add_document(_doc("gas gamma"))
        w.commit()
        n = w.delete_documents("body", "alpha")
        assert n == 1
        assert w.num_docs() == 2
        w.commit()

    r = DirectoryReader.open(d)
    assert r.num_docs() == 2
    td = _search(r, "oil")
    assert td.total_hits == 1


def test_delete_buffered_docs(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("oil alpha"))
        w.add_document(_doc("oil beta"))
        # no flush yet: delete must hit RAM-buffered docs too
        assert w.delete_documents("body", "alpha") == 1
        w.commit()
    r = DirectoryReader.open(d)
    assert r.num_docs() == 1


def test_update_document(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("oil version1 keyx"))
        w.commit()
        w.update_document("body", "keyx", _doc("oil version2 keyx"))
        w.commit()
    r = DirectoryReader.open(d)
    assert r.num_docs() == 1
    s = OracleSearcher(r.segments_data())
    assert s.search(TermQuery("body", "version2"), 10).total_hits == 1
    assert s.search(TermQuery("body", "version1"), 10).total_hits == 0


def test_merge_with_deletes_compacts(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    cfg = IndexWriterConfig(max_buffered_docs=3, merge_scheduler="serial")
    with IndexWriter(d, cfg) as w:
        for i in range(9):
            w.add_document(_doc(f"doc t{i} common", str(i)))
        w.flush()
        w.delete_documents("body", "t4")
        w.delete_documents("body", "t7")
        w.force_merge(1)
        w.commit()
    r = DirectoryReader.open(d)
    assert r.max_doc() == 7  # deletions compacted away
    assert r.num_docs() == 7
    ids = [r.document(i)["id"] for i in range(7)]
    assert ids == ["0", "1", "2", "3", "5", "6", "8"]


def test_rollback(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    w = IndexWriter(d, IndexWriterConfig(merge_scheduler="serial"))
    w.add_document(_doc("committed doc oil"))
    w.commit()
    w.add_document(_doc("uncommitted doc gas"))
    w.flush()
    w.rollback()
    assert w.num_docs() == 1
    w.close()
    r = DirectoryReader.open(d)
    assert r.max_doc() == 1
    # uncommitted segment files cleaned up
    stray = [f for f in d.list_files() if f.endswith(".bnd")]
    assert len(stray) == 1


def test_concurrent_merge_scheduler(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    cfg = IndexWriterConfig(
        max_buffered_docs=2,
        merge_scheduler="concurrent",
        merge_policy=TieredMergePolicy(segs_per_tier=2, max_merge_at_once=4),
    )
    with IndexWriter(d, cfg) as w:
        for i in range(20):
            w.add_document(_doc(f"background doc w{i} oil"))
        w.commit()
        w.wait_for_merges()
        w.commit_merge_results()
        assert w.segment_count < 10
    r = DirectoryReader.open(d)
    assert r.max_doc() == 20
    assert _search(r, "oil").total_hits == 20


def test_append_mode(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("first oil"))
        w.commit()
    with IndexWriter(
        d, IndexWriterConfig(open_mode="APPEND", merge_scheduler="serial")
    ) as w:
        w.add_document(_doc("second oil"))
        w.commit()
    r = DirectoryReader.open(d)
    assert r.max_doc() == 2
    assert _search(r, "oil").total_hits == 2


def test_create_mode_truncates(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(_doc("old oil"))
        w.commit()
    with IndexWriter(
        d, IndexWriterConfig(open_mode="CREATE", merge_scheduler="serial")
    ) as w:
        w.add_document(_doc("new gas"))
        w.commit()
    r = DirectoryReader.open(d)
    assert r.max_doc() == 1
    assert _search(r, "gas").total_hits == 1


def test_reader_reopen(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    w = IndexWriter(d, IndexWriterConfig(merge_scheduler="serial"))
    w.add_document(_doc("one oil"))
    w.commit()
    r1 = DirectoryReader.open(d)
    w.add_document(_doc("two oil"))
    w.commit()
    assert r1.max_doc() == 1  # point-in-time snapshot
    r2 = r1.reopen()
    assert r2.max_doc() == 2
    w.close()


def test_generation_cleanup(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        for i in range(3):
            w.add_document(_doc(f"gen doc {i}"))
            w.commit()
    gens = [f for f in d.list_files() if f.startswith("segments_")]
    assert len(gens) == 1  # stale generations removed
    assert find_latest_commit_gen(d) is not None


def test_merge_preserves_doc_values_and_points(tmp_path):
    from diagon_tpu_torch.document import (
        LongPointField,
        NumericDocValuesField,
        SortedDocValuesField,
    )
    from diagon_tpu_torch.search.query import (
        NumericRangeQuery,
        PointRangeQuery,
    )

    d = FSDirectory(tmp_path / "idx")
    cfg = IndexWriterConfig(max_buffered_docs=3, merge_scheduler="serial")
    with IndexWriter(d, cfg) as w:
        for i in range(9):
            w.add_document(
                Document()
                .add(TextField("body", f"doc t{i} common"))
                .add(NumericDocValuesField("views", i * 10))
                .add(LongPointField("ts", i * 100))
                .add(SortedDocValuesField("cat", chr(ord("a") + i % 3)))
            )
        w.delete_documents("body", "t4")
        w.force_merge(1)
        w.commit()

    r = DirectoryReader.open(d)
    assert r.max_doc() == 8
    s = OracleSearcher(r.segments_data())
    # views of surviving docs remapped in docid order: t4 (views 40) gone
    td = s.search(NumericRangeQuery("views", 30, 60), 10)
    views = sorted(
        r.segments_data()[0].doc_values["views"].values[i] for i in td.doc_ids()
    )
    assert views == [30, 50, 60]
    td2 = s.search(PointRangeQuery("ts", 700, None), 10)
    assert len(td2.doc_ids()) == 2  # t7, t8
    # sorted doc values ord table intact
    dv = r.segments_data()[0].doc_values["cat"]
    assert dv.ord_values == [b"a", b"b", b"c"]


def test_searcher_accepts_leaf_contexts(tmp_path):
    from diagon_tpu_torch.index import DirectoryReader as DR, IndexWriter as IW
    from diagon_tpu_torch.search import IndexSearcher

    w = IW(FSDirectory(str(tmp_path)))
    w.add_document(TDocument().add(TextField("b", "alpha beta")))
    w.commit()
    w.close()
    r = DR.open(FSDirectory(str(tmp_path)))
    s = IndexSearcher(r.leaves(), device="cpu")  # LeafReaderContext list
    assert s.search(TermQuery("b", "alpha"), k=5).total_hits == 1


# ---------------------------------------------------------------------------
# tests/unit/test_merge_policy.py
# ---------------------------------------------------------------------------


def _seg(n_docs, name, words_per_doc=20, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(50)]
    mem = MemoryIndex()
    for _ in range(n_docs):
        mem.add_document(Document().add(TextField(
            "body", " ".join(rng.choice(vocab, words_per_doc)))))
    return flush_memory_index(mem, name)


def test_within_budget_no_merge():
    p = TieredMergePolicy(segs_per_tier=10, max_merge_at_once=10)
    segs = [_seg(50, f"_{i}", seed=i) for i in range(5)]
    assert p.find_merges(segs).merges == []


def test_over_budget_selects_balanced_merge():
    p = TieredMergePolicy(segs_per_tier=2, max_merge_at_once=4)
    segs = [_seg(50, f"_{i}", seed=i) for i in range(6)]
    spec = p.find_merges(segs)
    assert len(spec.merges) == 1
    members = spec.merges[0].segments
    assert 2 <= len(members) <= 4


def test_max_merged_segment_cap():
    # max cap below 2x a single segment: nothing is eligible
    segs = [_seg(400, f"_{i}", seed=i) for i in range(6)]
    one = segment_size_bytes(segs[0])
    p = TieredMergePolicy(
        segs_per_tier=2, max_merge_at_once=4,
        floor_segment_mb=one / (1024 * 1024) / 4,
        max_merged_segment_mb=one / (1024 * 1024) * 1.5,
    )
    assert p.find_merges(segs).merges == []


def test_delete_adjusted_sizes():
    p = TieredMergePolicy()
    big = _seg(600, "_big")
    full = p._adjusted(big)
    for d in range(540):
        big.delete_document(d)  # 90% deleted
    adj = p._adjusted(big)
    assert abs(adj - 0.1 * full) / full < 0.01
    small = [_seg(200, f"_s{i}", seed=i) for i in range(12)]
    one = segment_size_bytes(small[0])
    p2 = TieredMergePolicy(
        segs_per_tier=2, max_merge_at_once=4,
        floor_segment_mb=one / (1024 * 1024),
        max_merged_segment_mb=full / (1024 * 1024),
    )
    spec = p2.find_merges([big] + small)
    assert len(spec.merges) == 1
    assert 2 <= len(spec.merges[0].segments) <= 4


def test_forced_deletes_merges():
    p = TieredMergePolicy()
    a = _seg(100, "_a")
    for d in range(30):
        a.delete_document(d)  # 30% deleted
    b = _seg(100, "_b", seed=1)  # clean
    spec = p.find_forced_deletes_merges([a, b])
    assert len(spec.merges) == 1
    assert spec.merges[0].segments == [a]
    merged, _ = SegmentMerger.merge(spec.merges[0].segments, "_m")
    assert merged.num_docs == 70


def test_allowed_count_grows_with_total_size():
    p = TieredMergePolicy(segs_per_tier=4, max_merge_at_once=4)
    tiny = [1.0] * 3
    assert p._allowed_count(tiny) >= 3  # under floor: one tier
    many = [2.0 * 1024 * 1024] * 40
    allowed = p._allowed_count(many)
    assert 4 <= allowed < 40


def test_field_infos_write_time_drift():
    from diagon_tpu_torch.document.document import (
        DoublePointField,
        LongPointField,
        NumericDocValuesField,
        SortedDocValuesField,
    )
    from diagon_tpu_torch.index.field_infos import FieldSchemaError

    mem = MemoryIndex()
    mem.add_document(Document().add(NumericDocValuesField("rank", 5)))
    with pytest.raises(FieldSchemaError):
        mem.add_document(Document().add(SortedDocValuesField("rank", b"x")))

    mem2 = MemoryIndex()
    mem2.add_document(Document().add(LongPointField("year", 1999)))
    with pytest.raises(FieldSchemaError):
        mem2.add_document(Document().add(DoublePointField("year", 2.5)))

    # bulk path sights too
    mem3 = MemoryIndex()
    mem3.add_documents([Document().add(NumericDocValuesField("rank", 5))])
    with pytest.raises(FieldSchemaError):
        mem3.add_documents(
            [Document().add(SortedDocValuesField("rank", b"x"))])


def test_field_infos_merge_time_drift():
    from diagon_tpu_torch.document.document import (
        DoublePointField,
        LongPointField,
    )
    from diagon_tpu_torch.index.field_infos import FieldSchemaError

    def seg_with(field, name):
        mem = MemoryIndex()
        mem.add_document(
            Document().add(TextField("body", "oil")).add(field))
        return flush_memory_index(mem, name)

    a = seg_with(LongPointField("year", 1999), "_a")
    b = seg_with(DoublePointField("year", 2.5), "_b")
    with pytest.raises(FieldSchemaError):
        SegmentMerger.merge([a, b], "_m")
    # consistent segments merge fine and carry infos
    c = seg_with(LongPointField("year", 2001), "_c")
    merged, _ = SegmentMerger.merge([a, c], "_m2")
    fi = merged.field_infos.field_info("year")
    assert fi is not None and fi.point_dims == 1 and not fi.point_double


def test_flush_attaches_field_infos():
    seg = _seg(10, "_x")
    assert seg.field_infos is not None
    fi = seg.field_infos.field_info("body")
    assert fi is not None


@pytest.mark.parametrize("segs_per_tier,max_at_once,deletes", [
    (10, 10, 0), (2, 4, 0), (2, 4, 90), (3, 3, 30)])
def test_merge_policy_choices_match_jax(segs_per_tier, max_at_once, deletes):
    """On the same segments (flushed by each package from the same
    documents, some deleted) the sizes, the allowance and every policy's
    choice equal the JAX package's."""
    from diagon_tpu.index.memory_index import MemoryIndex as JM
    from diagon_tpu.index.merge import (
        TieredMergePolicy as JP,
        segment_size_bytes as j_size,
    )
    from diagon_tpu.index.segment import flush_memory_index as j_flush

    tsegs, jsegs = [], []
    for i, n in enumerate([40, 200, 60, 300, 50, 120, 80]):
        tdocs, jdocs = both_docs(corpus_spec(i, n, unicode_every=5))
        tm, jm = MemoryIndex(), JM()
        tm.add_documents(tdocs)
        jm.add_documents(jdocs)
        tsegs.append(flush_memory_index(tm, f"_{i}"))
        jsegs.append(j_flush(jm, f"_{i}"))
        for d in range(0, n * deletes // 100):
            tsegs[-1].delete_document(d)
            jsegs[-1].delete_document(d)
    assert [segment_size_bytes(s) for s in tsegs] == [j_size(s) for s in jsegs]
    one = segment_size_bytes(tsegs[0]) / (1024 * 1024)
    kw = dict(segs_per_tier=segs_per_tier, max_merge_at_once=max_at_once,
              floor_segment_mb=one / 2, max_merged_segment_mb=one * 30)
    tp, jp = TieredMergePolicy(**kw), JP(**kw)
    names = lambda spec: [[s.name for s in m.segments] for m in spec.merges]
    assert names(tp.find_merges(tsegs)) == names(jp.find_merges(jsegs))
    assert (names(tp.find_forced_merges(tsegs, 2))
            == names(jp.find_forced_merges(jsegs, 2)))
    assert (names(tp.find_forced_deletes_merges(tsegs))
            == names(jp.find_forced_deletes_merges(jsegs)))
    sizes = [tp._adjusted(s) for s in tsegs]
    assert sizes == [jp._adjusted(s) for s in jsegs]
    assert tp._allowed_count(sizes) == jp._allowed_count(sizes)


# ---------------------------------------------------------------------------
# tests/unit/test_csr_packer.py, and the dict packer against the JAX one
# ---------------------------------------------------------------------------


def _make_csr(rng, num_terms, num_docs, max_df, with_pos=True):
    terms = sorted(f"t{i:04d}" for i in range(num_terms))
    entry_start = [0]
    docs_l, freqs_l, pos_start_l, pos_l = [], [], [0], []
    for t in terms:
        df = int(rng.integers(1, max_df + 1))
        docs = np.sort(rng.choice(num_docs, size=min(df, num_docs),
                                  replace=False))
        freqs = rng.integers(1, 40, size=len(docs))
        docs_l.append(docs)
        freqs_l.append(freqs)
        entry_start.append(entry_start[-1] + len(docs))
        if with_pos:
            for f in freqs:
                p = np.sort(rng.choice(5000, size=int(f), replace=False))
                pos_l.append(p)
                pos_start_l.append(pos_start_l[-1] + int(f))
    out = dict(
        terms=terms,
        entry_start=np.asarray(entry_start, np.int64),
        docs=np.concatenate(docs_l).astype(np.int32),
        freqs=np.concatenate(freqs_l).astype(np.int32),
    )
    if with_pos:
        out["pos_start"] = np.asarray(pos_start_l, np.int64)
        out["positions"] = (np.concatenate(pos_l).astype(np.int32) if pos_l
                            else np.zeros(0, np.int32))
    return out


def _dict_form(csr):
    d, dpos = {}, {}
    for tid, t in enumerate(csr["terms"]):
        s, e = csr["entry_start"][tid], csr["entry_start"][tid + 1]
        d[t] = (csr["docs"][s:e].astype(np.int64),
                csr["freqs"][s:e].astype(np.int64))
        dpos[t] = [csr["positions"][csr["pos_start"][j]:csr["pos_start"][j + 1]]
                   for j in range(s, e)]
    return d, dpos


@pytest.mark.parametrize("seed,num_terms,max_df", [(1, 40, 700), (2, 5, 3),
                                                   (3, 100, 140)])
def test_csr_equals_dict_packer(seed, num_terms, max_df):
    """The CSR packer and the port's dict packer give the same arrays, and
    both equal the JAX package's dict packer (every array, dtypes
    included)."""
    from diagon_tpu.codecs.postings import build_packed_postings as j_pack
    from diagon_tpu_torch.codecs.postings import (
        build_packed_postings,
        build_packed_postings_csr,
        decode_block_numpy,
    )

    rng = np.random.Generator(np.random.PCG64(seed))
    num_docs = 4000
    csr = _make_csr(rng, num_terms, num_docs, max_df)
    norms = rng.integers(1, 127, size=num_docs).astype(np.uint8)
    d, dpos = _dict_form(csr)

    ref = build_packed_postings(d, dpos, norms)
    got = build_packed_postings_csr(
        csr["terms"], csr["entry_start"], csr["docs"], csr["freqs"],
        csr["pos_start"], csr["positions"], norms,
    )
    for name in ("block_start", "doc_freq", "total_tf", "block_term",
                 "block_base", "block_count", "block_doc_bits",
                 "block_freq_bits", "block_word_off", "block_max_freq",
                 "block_max_norm", "block_entry_start", "packed",
                 "pos_start", "positions"):
        same_array(name, getattr(got, name), getattr(ref, name))
    assert got.terms == ref.terms
    assert (got.sum_total_tf, got.sum_doc_freq, got.max_window_words) == (
        ref.sum_total_tf, ref.sum_doc_freq, ref.max_window_words)
    for b in range(ref.num_blocks):
        rd, rf = decode_block_numpy(ref, b)
        gd, gf = decode_block_numpy(got, b)
        np.testing.assert_array_equal(rd, gd)
        np.testing.assert_array_equal(rf, gf)

    want = j_pack(d, dpos, norms)
    for name in ("block_start", "doc_freq", "total_tf", "block_term",
                 "block_base", "block_count", "block_doc_bits",
                 "block_freq_bits", "block_word_off", "block_max_freq",
                 "block_max_norm", "block_entry_start", "packed",
                 "pos_start", "positions"):
        same_array(f"jax {name}", getattr(ref, name), getattr(want, name))
    assert ref.terms == want.terms
    assert (ref.sum_total_tf, ref.sum_doc_freq, ref.max_window_words) == (
        want.sum_total_tf, want.sum_doc_freq, want.max_window_words)


def test_csr_empty():
    from diagon_tpu.codecs.postings import build_packed_postings as j_pack
    from diagon_tpu_torch.codecs.postings import (
        build_packed_postings,
        build_packed_postings_csr,
    )

    pp = build_packed_postings_csr([], np.zeros(1, np.int64),
                                   np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert pp.num_terms == 0 and pp.num_blocks == 0
    for positions in (None, {}):
        got, want = build_packed_postings({}, positions), j_pack({}, positions)
        same_array("packed", got.packed, want.packed)
        for name in ("pos_start", "positions"):
            if getattr(want, name) is None:
                assert getattr(got, name) is None
            else:
                same_array(name, getattr(got, name), getattr(want, name))


# ---------------------------------------------------------------------------
# the same documents through both writers
# ---------------------------------------------------------------------------


def _writers(tmp_path, **cfg):
    from diagon_tpu.index.writer import IndexWriter as JW, IndexWriterConfig as JC
    from diagon_tpu.store import FSDirectory as JF

    td, jd = FSDirectory(tmp_path / "port"), JF(tmp_path / "jax")
    cfg.setdefault("merge_scheduler", "serial")
    return (td, IndexWriter(td, IndexWriterConfig(**cfg)),
            jd, JW(jd, JC(**cfg)))


def _drive(w, docs, step, deletes):
    """Per-document adds and bulk adds in turn, a commit, deletes by term,
    a forced merge to two segments, a commit."""
    for i in range(0, len(docs), step):
        chunk = docs[i:i + step]
        if (i // step) % 2:
            w.add_documents(chunk)
        else:
            for d in chunk:
                w.add_document(d)
    w.commit()
    n = sum(w.delete_documents(f, t) for f, t in deletes)
    w.commit()
    w.force_merge(2)
    w.commit_merge_results()
    return n


DELETES = [("cat", "c1"), ("body", "w3"), ("place", "café")]


def test_files_byte_equal_and_read_across(tmp_path):
    """Both writers, driven alike (adds, bulk adds, flushes, commits,
    deletes, merges), leave the same files, byte for byte: ``.bnd``,
    ``.liv`` and ``segments_N``; each package opens the other's index into
    segments equal to its own reading."""
    from diagon_tpu.index.reader import DirectoryReader as JDR

    spec = corpus_spec(3, 400, unicode_every=6, dup_every=9)
    tdocs, jdocs = both_docs(spec)
    td, tw, jd, jw = _writers(tmp_path, max_buffered_docs=70)
    assert _drive(tw, tdocs, 45, DELETES) == _drive(jw, jdocs, 45, DELETES)
    assert [s.name for s in tw._segments] == [s.name for s in jw._segments]
    tw.close()
    jw.close()
    files = sorted(f for f in td.list_files() if f != "write.lock")
    assert files == sorted(f for f in jd.list_files() if f != "write.lock")
    assert any(f.endswith(".liv") for f in files)
    for f in files:
        assert td.read_bytes(f) == jd.read_bytes(f), f
    port_of_jax = DirectoryReader.open(jd, verify_checksums=True)
    jax_of_port = JDR.open(td)
    mine, theirs = DirectoryReader.open(td), JDR.open(jd)
    for a, b in zip(port_of_jax.segments_data(), mine.segments_data()):
        assert_segments_equal(a, b)
    for a, b in zip(mine.segments_data(), jax_of_port.segments_data()):
        assert_segments_equal(a, b)
    for a, b in zip(mine.segments_data(), theirs.segments_data()):
        assert_segments_equal(a, b)


@pytest.mark.parametrize("seed", [1, 2])
def test_merge_with_deletes_matches_jax(seed):
    """SegmentMerger.merge of in-memory segments with deletes (and a
    live-docs snapshot older than the deletes) equals the JAX merger's
    segment, field infos included, and its doc maps."""
    from diagon_tpu.index.memory_index import MemoryIndex as JM
    from diagon_tpu.index.merge import SegmentMerger as JSM
    from diagon_tpu.index.segment import flush_memory_index as j_flush

    tsegs, jsegs = [], []
    rng = np.random.default_rng(seed)
    for i, n in enumerate([120, 30, 200]):
        tdocs, jdocs = both_docs(corpus_spec(10 * seed + i, n,
                                             unicode_every=4, dup_every=7))
        tm, jm = MemoryIndex(), JM()
        for t, j in zip(tdocs, jdocs):
            tm.add_document(t)
            jm.add_document(j)
        tsegs.append(flush_memory_index(tm, f"_{i}"))
        jsegs.append(j_flush(jm, f"_{i}"))
        for d in rng.choice(n, n // 4, replace=False):
            assert tsegs[-1].delete_document(int(d)) == jsegs[-1].delete_document(
                int(d))
    got, gmaps = SegmentMerger.merge(tsegs, "_m")
    want, wmaps = JSM.merge(jsegs, "_m")
    assert_segments_equal(got, want)
    for a, b in zip(gmaps, wmaps):
        same_array("doc map", a, b)
    live = [np.ones(s.num_docs, bool) for s in tsegs]
    got, _ = SegmentMerger.merge(tsegs, "_m", live=live)
    want, _ = JSM.merge(jsegs, "_m", live=live)
    assert_segments_equal(got, want)


def test_merged_index_serves_the_oracle(tmp_path):
    """A port-written, merged index with deletes: the port's searcher (CPU)
    returns the oracle's top-k, score bits and hits, and the JAX oracle's
    over the JAX-written twin."""
    from diagon_tpu.index.reader import DirectoryReader as JDR
    from diagon_tpu.search.oracle import OracleSearcher as JO
    from diagon_tpu.search.query import (
        BooleanClause as JBC,
        BooleanQuery as JBQ,
        Occur as JOc,
        PhraseQuery as JPQ,
        TermQuery as JTQ,
    )
    from diagon_tpu_torch.search import IndexSearcher
    from diagon_tpu_torch.search.convert import query_from_jax

    tdocs, jdocs = both_docs(corpus_spec(8, 600, unicode_every=9))
    td, tw, jd, jw = _writers(tmp_path, max_buffered_docs=150)
    _drive(tw, tdocs, 100, DELETES)
    _drive(jw, jdocs, 100, DELETES)
    tw.force_merge(1)
    jw.force_merge(1)
    tw.close()
    jw.close()
    r, jr = DirectoryReader.open(td), JDR.open(jd)
    assert len(r.leaves()) == 1
    s = IndexSearcher(r, device="cpu")
    oracle, joracle = OracleSearcher(r.segments_data()), JO(jr.segments_data())
    S, M, N = JOc.SHOULD, JOc.MUST, JOc.MUST_NOT
    queries = [
        JTQ("body", "oil"), JTQ("body", "w7"), JTQ("cat", "c2"),
        JTQ("place", "東京"),
        JBQ([JBC(JTQ("body", t), S) for t in ("oil", "price", "w1", "w9")]),
        JBQ([JBC(JTQ("body", "w2"), M), JBC(JTQ("body", "w5"), S),
             JBC(JTQ("body", "w8"), N)]),
        JPQ("body", ["w1", "w2"]),
    ]
    for q in queries:
        p = query_from_jax(q)
        got, want, jwant = s.search(p, 10), oracle.search(p, 10), joracle.search(q, 10)
        for a, b in ((got, want), (want, jwant)):
            assert a.total_hits == b.total_hits, q
            assert a.doc_ids() == b.doc_ids(), q
            sa = np.asarray([x.score for x in a.score_docs], np.float32)
            sb = np.asarray([x.score for x in b.score_docs], np.float32)
            assert np.array_equal(sa.view(np.uint32), sb.view(np.uint32)), q


def _reopened_append(path, module_writer, module_dir, docs, split):
    """Commit ``docs[:split]``, close, reopen in APPEND mode, add the rest,
    commit and force one segment: the F2 path."""
    IW, IC = module_writer.IndexWriter, module_writer.IndexWriterConfig
    d = module_dir.FSDirectory(path)
    with IW(d, IC(merge_scheduler="serial")) as w:
        w.add_documents(docs[:split])
        w.commit()
    w = IW(d, IC(open_mode="APPEND", merge_scheduler="serial"))
    w.add_documents(docs[split:])
    w.commit()
    try:
        w.force_merge(1)
        return w._segments
    finally:
        w.rollback()
        w.close()


def test_reopened_append_merge(tmp_path):
    """F2: a merge that takes in a segment read from disk (lazy positions)
    raises IndexError in the JAX package; the port's merged segment equals
    the merge both packages make of the same segments kept in memory."""
    import diagon_tpu.index.writer as JWm
    import diagon_tpu.store as JSt
    import diagon_tpu_torch.index.writer as TWm
    import diagon_tpu_torch.store as TSt
    from diagon_tpu.index.memory_index import MemoryIndex as JM
    from diagon_tpu.index.merge import SegmentMerger as JSM
    from diagon_tpu.index.segment import flush_memory_index as j_flush

    tdocs, jdocs = both_docs(corpus_spec(4, 300, unicode_every=8))
    with pytest.raises(IndexError):
        _reopened_append(tmp_path / "jax", JWm, JSt, jdocs, 150)
    (got,) = _reopened_append(tmp_path / "port", TWm, TSt, tdocs, 150)

    tparts, jparts = [], []
    for i, (lo, hi) in enumerate([(0, 150), (150, 300)]):
        tm, jm = MemoryIndex(), JM()
        tm.add_documents(tdocs[lo:hi])
        jm.add_documents(jdocs[lo:hi])
        tparts.append(flush_memory_index(tm, f"_{i}"))
        jparts.append(j_flush(jm, f"_{i}"))
    want_port, _ = SegmentMerger.merge(tparts, got.name)
    want_jax, _ = JSM.merge(jparts, got.name)
    assert_segments_equal(got, want_port, infos=False)
    assert_segments_equal(got, want_jax, infos=False)


def test_delete_and_merge_a_reopened_segment_without_warnings(tmp_path):
    """Trap 7: a segment reopened from disk holds read-only mmap views;
    deleting from it (live docs are its own array) and merging it (reads
    only) raise no warning, and the merged index drops the deleted docs."""
    d = FSDirectory(tmp_path / "idx")
    tdocs, _ = both_docs(corpus_spec(6, 120))
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial",
                                          max_buffered_docs=50)) as w:
        w.add_documents(tdocs[:60])
        w.add_documents(tdocs[60:])
        w.commit()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        w = IndexWriter(d, IndexWriterConfig(open_mode="APPEND",
                                             merge_scheduler="serial"))
        n = w.delete_documents("cat", "c3")
        assert n > 0
        w.force_merge(1)
        w.close()
        r = DirectoryReader.open(d)
        assert len(r.leaves()) == 1
        assert r.max_doc() == r.num_docs() == 120 - n
        assert OracleSearcher(r.segments_data()).search(
            TermQuery("cat", "c3"), 10).total_hits == 0


def _adds_and_deletes(path, tdocs, scheduler):
    """600 docs in bulk adds of 20 with a commit after each, and a delete
    by term after every fifth; returns the live stored ids and the count
    the deletes reported."""
    d = FSDirectory(path)
    cfg = IndexWriterConfig(
        max_buffered_docs=20, merge_scheduler=scheduler,
        merge_policy=TieredMergePolicy(segs_per_tier=2, max_merge_at_once=3))
    w = IndexWriter(d, cfg)
    deleted = 0
    for i in range(0, 600, 20):
        w.add_documents(tdocs[i:i + 20])
        if i % 100 == 60:
            deleted += w.delete_documents("body", f"w{i % 80}")
        w.commit()
    w.wait_for_merges()
    t = threading.Thread(target=w.close)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    r = DirectoryReader.open(d)
    ids = [r.document(i)["id"] for i in range(r.max_doc()) if _live(r, i)]
    assert len(ids) == r.num_docs()
    return sorted(ids), deleted


def test_concurrent_merges_under_adds_and_deletes(tmp_path):
    """Adds and deletes on the caller's thread while the concurrent
    scheduler merges on its own (switch interval shortened): no document
    is lost or duplicated and every delete lands, as with the serial
    scheduler."""
    tdocs, _ = both_docs(corpus_spec(9, 600))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got, n = _adds_and_deletes(tmp_path / "c", tdocs, "concurrent")
    finally:
        sys.setswitchinterval(old)
    want, n_want = _adds_and_deletes(tmp_path / "s", tdocs, "serial")
    assert n == n_want > 0
    assert len(got) == len(set(got)) == 600 - n
    assert got == want


def _live(reader, doc):
    for leaf in reversed(reader.leaves()):
        if doc >= leaf.doc_base:
            live = leaf.reader.live_docs()
            return live is None or bool(live[doc - leaf.doc_base])
    return False
