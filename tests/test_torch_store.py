"""The port's store tier (``diagon_tpu_torch.store``, ``index.reader``,
``index.writer``'s commit files, ``codecs.registry``) on the CPU.

The cases of ``tests/unit/test_store.py`` are mirrored on the port's
classes. Segments come from the JAX ``MemoryIndex`` through
``convert.segment_from_jax`` (the port has no document writer yet). Across
the packages: the bundle bytes the port writes equal the JAX writer's; a
segment either package writes loads in the other with every array equal;
and a multi-segment index with deletes that the JAX ``IndexWriter``
commits, opened by the port's ``DirectoryReader`` and served by the port's
``IndexSearcher(device="cpu")``, gives the JAX searcher's top-k docids,
f32 score bits and hit counts.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest

import diagon_tpu.store as jstore
from diagon_tpu.document import (
    Document,
    DoublePointField,
    LongPointField,
    NumericDocValuesField,
    SortedDocValuesField,
    SortedNumericDocValuesField,
    SortedSetDocValuesField,
    StoredField,
    StringField,
    TextField,
)
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu_torch.codecs.postings import (
    PackedPostings,
    decode_all_numpy,
    decode_block_numpy,
)
from diagon_tpu_torch.index import (
    DirectoryReader,
    SegmentInfo,
    SegmentInfos,
    SegmentReader,
)
from diagon_tpu_torch.index.writer import (
    _gen_name,
    _parse_gen,
    find_latest_commit_gen,
    read_segment_infos,
)
from diagon_tpu_torch.search.convert import query_from_jax, segment_from_jax
from diagon_tpu_torch.store import (
    ArrayBundleReader,
    ArrayBundleWriter,
    FSDirectory,
    LockObtainFailedError,
    RAMDirectory,
    read_segment,
    write_segment,
)


# ---------------------------------------------------------------------------
# Mirrors of tests/unit/test_store.py on the port's classes
# ---------------------------------------------------------------------------


def test_bundle_roundtrip():
    w = ArrayBundleWriter({"hello": 1})
    a = np.arange(100, dtype=np.int32)
    b = np.random.default_rng(0).random((7, 3)).astype(np.float32)
    c = np.array([], dtype=np.uint32)
    w.add("a", a)
    w.add("b", b)
    w.add("c", c)
    data = w.tobytes()

    r = ArrayBundleReader(np.frombuffer(data, dtype=np.uint8),
                          verify_checksums=True)
    assert r.meta == {"hello": 1}
    np.testing.assert_array_equal(r.array("a"), a)
    np.testing.assert_array_equal(r.array("b"), b)
    assert r.array("c").shape == (0,)
    assert r.names() == ["a", "b", "c"]
    # 64-byte aligned sections, so every view is a zero-copy dtype view
    assert all(r._dir[n]["offset"] % 64 == 0 for n in r.names())


def test_bundle_detects_corruption():
    w = ArrayBundleWriter()
    w.add("x", np.arange(64, dtype=np.int64))
    data = bytearray(w.tobytes())
    data[-30] ^= 0xFF  # flip a bit in the data section
    with pytest.raises(IOError):
        ArrayBundleReader(np.frombuffer(bytes(data), np.uint8),
                          verify_checksums=True)
    # the header checksum is checked on every open
    data = bytearray(w.tobytes())
    data[20] ^= 0x01
    with pytest.raises((IOError, ValueError)):
        ArrayBundleReader(np.frombuffer(bytes(data), np.uint8))


def test_fs_directory(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    d.write_bytes("a.bin", b"hello")
    assert d.read_bytes("a.bin") == b"hello"
    assert d.file_length("a.bin") == 5
    assert d.list_files() == ["a.bin"]
    mm = d.open_mmap("a.bin")
    assert bytes(mm) == b"hello"
    assert d.create_atomic("a.bin", b"x") is False
    assert d.create_atomic("c.bin", b"x") is True
    d.sync(["a.bin", "c.bin"])
    d.rename("a.bin", "b.bin")
    assert d.list_files() == ["b.bin", "c.bin"]
    d.delete_file("b.bin")
    d.delete_file("c.bin")
    assert d.list_files() == []
    with pytest.raises(ValueError):
        d.write_bytes("../evil", b"x")


def test_lock(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    lock = d.obtain_lock()
    with pytest.raises(LockObtainFailedError):
        d.obtain_lock()
    lock.release()
    d.obtain_lock().release()
    held = d.obtain_lock()
    d.obtain_lock(force=True).release()  # a stale lock cleared by force
    held.release()


def _rich_jax_segment():
    mem = MemoryIndex()
    mem.add_document(
        Document()
        .add(TextField("body", "oil price rises on oil news"))
        .add(StringField("tag", "energy"))
        .add(NumericDocValuesField("views", 42))
        .add(SortedDocValuesField("cat", "a"))
        .add(LongPointField("ts", 100))
        .add(StoredField("id", "d0"))
    )
    mem.add_document(
        Document()
        .add(TextField("body", "trade deficit data"))
        .add(NumericDocValuesField("views", 7))
        .add(SortedDocValuesField("cat", "b"))
        .add(LongPointField("ts", 200))
        .add(StoredField("id", "d1"))
    )
    return flush_memory_index(mem, "_0")


def _rich_segment():
    return segment_from_jax(_rich_jax_segment())


@pytest.mark.parametrize("dir_kind", ["fs", "ram"])
def test_segment_roundtrip(tmp_path, dir_kind):
    d = FSDirectory(tmp_path / "idx") if dir_kind == "fs" else RAMDirectory()
    seg = _rich_segment()
    seg.delete_document(1)
    files = write_segment(d, seg)
    assert f"{seg.name}.bnd" in files and f"{seg.name}.liv" in files

    got = read_segment(d, seg.name, verify_checksums=True)
    assert got.num_docs == seg.num_docs
    assert got.num_live_docs == 1

    for fname in seg.fields:
        a, b = seg.fields[fname].postings, got.fields[fname].postings
        assert a.terms == b.terms
        np.testing.assert_array_equal(a.packed, b.packed)
        np.testing.assert_array_equal(a.block_base, b.block_base)
        np.testing.assert_array_equal(seg.fields[fname].norms,
                                      got.fields[fname].norms)
        assert a.sum_total_tf == b.sum_total_tf
        for blk in range(a.num_blocks):
            da, fa = decode_block_numpy(a, blk)
            db, fb = decode_block_numpy(b, blk)
            np.testing.assert_array_equal(da, db)
            np.testing.assert_array_equal(fa, fb)

    # positions decode lazily on read: force them first
    body = got.fields["body"].postings
    assert body.pos_start is None and body.pos_loader is not None
    body.ensure_positions()
    np.testing.assert_array_equal(seg.fields["body"].postings.positions,
                                  body.positions)
    np.testing.assert_array_equal(seg.fields["body"].postings.pos_start,
                                  body.pos_start)
    np.testing.assert_array_equal(got.doc_values["views"].values, [42, 7])
    assert got.doc_values["cat"].ord_values == [b"a", b"b"]
    np.testing.assert_array_equal(got.points["ts"].values, [100, 200])
    assert got.stored[1]["id"] == "d1"


def test_search_on_reloaded_segment(tmp_path):
    from diagon_tpu_torch.search import IndexSearcher
    from diagon_tpu_torch.search.oracle import OracleSearcher
    from diagon_tpu_torch.search.query import TermQuery

    d = FSDirectory(tmp_path / "idx")
    seg = _rich_segment()
    write_segment(d, seg)
    got = read_segment(d, seg.name)
    td = OracleSearcher([got]).search(TermQuery("body", "oil"), 10)
    assert td.doc_ids() == [0]
    td = IndexSearcher([got], device="cpu").search(TermQuery("body", "oil"),
                                                   10)
    assert td.doc_ids() == [0]


def test_codec_registry():
    from diagon_tpu_torch.codecs.registry import (
        Codec,
        available_codecs,
        for_name,
    )

    assert "DiagonTPU1" in available_codecs()
    c = for_name("DiagonTPU1")
    assert c.name == "DiagonTPU1"
    with pytest.raises(ValueError):
        for_name("NoSuchCodec")

    # bundles record their codec, and the reader dispatches other names
    # through the registry
    d = RAMDirectory()
    seg = _rich_segment()
    write_segment(d, seg)
    r = ArrayBundleReader(d.open_mmap(f"{seg.name}.bnd"))
    assert r.meta["codec"] == "DiagonTPU1"

    calls = []

    def read_other(directory, name, verify):
        calls.append((name, verify))
        return "other"

    Codec("PortTestCodec", write_segment, read_other).register()
    meta = dict(r.meta, codec="PortTestCodec")
    w = ArrayBundleWriter(meta)
    d.write_bytes("_x.bnd", w.tobytes())
    assert read_segment(d, "_x", verify_checksums=True) == "other"
    assert calls == [("_x", True)]


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

VOCAB = [f"w{i}" for i in range(40)] + ["oil", "price", "trade"]


def _doc(rng, i):
    words = rng.choice(VOCAB, size=int(rng.integers(3, 40)))
    d = (Document()
         .add(TextField("body", " ".join(words)))
         .add(TextField("title", " ".join(rng.choice(VOCAB[:10], 3))))
         .add(StringField("tag", f"t{int(rng.integers(0, 5))}"))
         .add(NumericDocValuesField("views", int(rng.integers(0, 100))))
         .add(LongPointField("ts", int(rng.integers(0, 1000))))
         .add(DoublePointField("score", float(rng.random())))
         .add(StoredField("id", f"doc{i}")))
    if i % 3:
        d.add(SortedDocValuesField("cat", f"c{int(rng.integers(0, 7))}"))
    if i % 4 == 0:
        for v in rng.integers(0, 50, 2):
            d.add(SortedNumericDocValuesField("nums", int(v)))
        for v in rng.choice(["x", "y", "z"], 2):
            d.add(SortedSetDocValuesField("tags", str(v)))
    return d


def _jax_segment(n, seed, name, delete_every=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    mem = MemoryIndex()
    for i in range(n):
        mem.add_document(_doc(rng, i))
    seg = flush_memory_index(mem, name)
    if delete_every:
        for d in range(3, n, delete_every):
            seg.delete_document(d)
    return seg


@pytest.fixture(scope="module", params=[(40, 1, 0), (600, 2, 7)],
                ids=["40docs", "600docs_deletes"])
def jax_seg(request):
    n, seed, every = request.param
    return _jax_segment(n, seed, f"_s{seed}", every)


def _assert_segments_equal(a, b):
    """Every array of two segments (either package's) equal, positions
    after ensure_positions, with the same dtypes."""
    assert (a.name, a.num_docs) == (b.name, b.num_docs)
    assert list(a.fields) == list(b.fields)
    for fname, fa in a.fields.items():
        fb = b.fields[fname]
        assert fa.with_positions == fb.with_positions
        np.testing.assert_array_equal(fa.norms, fb.norms)
        assert fa.norms.dtype == fb.norms.dtype
        pa, pb = fa.postings, fb.postings
        pa.ensure_positions()
        pb.ensure_positions()
        for f in dataclasses.fields(PackedPostings):
            if f.name == "pos_loader":
                continue
            x, y = getattr(pa, f.name), getattr(pb, f.name)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, (fname, f.name, x.dtype, y.dtype)
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, (fname, f.name)
    assert list(a.doc_values) == list(b.doc_values)
    for fname, da in a.doc_values.items():
        db = b.doc_values[fname]
        assert da.dv_type.name == db.dv_type.name
        assert da.ord_values == db.ord_values
        for k in ("docs", "values", "value_start"):
            x, y = getattr(da, k), getattr(db, k)
            assert (x is None) == (y is None), k
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    assert list(a.points) == list(b.points)
    for fname, pa in a.points.items():
        pb = b.points[fname]
        assert pa.is_double == pb.is_double
        np.testing.assert_array_equal(pa.values, pb.values)
        np.testing.assert_array_equal(pa.docs, pb.docs)
    assert list(a.stored) == list(b.stored)
    if a.live_docs is None:
        assert b.live_docs is None
    else:
        np.testing.assert_array_equal(a.live_docs, b.live_docs)


def test_bundle_bytes_equal_the_jax_writers(jax_seg):
    """The .bnd (and .liv) bytes the port writes for a segment are the JAX
    writer's for the same segment."""
    jd, td = jstore.RAMDirectory(), RAMDirectory()
    jfiles = jstore.write_segment(jd, jax_seg)
    tfiles = write_segment(td, segment_from_jax(jax_seg))
    assert jfiles == tfiles
    assert (f"{jax_seg.name}.liv" in tfiles) == (jax_seg.live_docs is not None)
    for f in tfiles:
        assert td.read_bytes(f) == jd.read_bytes(f), f


@pytest.mark.parametrize("verify", [False, True])
def test_a_jax_written_segment_loads_in_the_port(tmp_path, jax_seg, verify):
    jstore.write_segment(jstore.FSDirectory(tmp_path), jax_seg)
    want = jstore.read_segment(jstore.FSDirectory(tmp_path), jax_seg.name)
    got = read_segment(FSDirectory(tmp_path), jax_seg.name, verify)
    _assert_segments_equal(got, want)
    # and the loaded arrays equal the in-memory segment's too
    _assert_segments_equal(got, segment_from_jax(jax_seg))


def test_a_port_written_segment_loads_in_the_jax_package(tmp_path, jax_seg):
    write_segment(FSDirectory(tmp_path), segment_from_jax(jax_seg))
    got = jstore.read_segment(jstore.FSDirectory(tmp_path), jax_seg.name,
                              verify_checksums=True)
    _assert_segments_equal(got, jax_seg)


def test_loaded_arrays_are_read_only_views_until_decoded(tmp_path, jax_seg):
    """``read_segment`` maps the file: postings are read-only views, and
    the positions stay undecoded until ``ensure_positions``."""
    write_segment(FSDirectory(tmp_path), segment_from_jax(jax_seg))
    got = read_segment(FSDirectory(tmp_path), jax_seg.name)
    pp = got.fields["body"].postings
    assert not pp.packed.flags.writeable
    assert pp.pos_start is None and pp.has_positions
    docs, freqs = decode_all_numpy(pp)
    pp.ensure_positions()
    assert pp.pos_start[-1] == freqs.sum() == len(pp.positions)


def test_a_bulk_built_segment_round_trips_with_its_dtypes(tmp_path):
    """The port's own synthetic segment (``bulk_build``, as the card's
    1M-doc pass builds it) written and read back: every array equal, with
    the dtypes the kernels' wrappers check, although the file narrows
    some of them."""
    from diagon_tpu_torch.bench.bulk_build import build_synthetic_segment

    seg = build_synthetic_segment(3000)
    d = FSDirectory(tmp_path)
    write_segment(d, seg)
    got = read_segment(d, seg.name, verify_checksums=True)
    _assert_segments_equal(got, seg)


def test_commit_files_and_directory_reader(tmp_path):
    """A commit made by hand (``write_segment`` and a ``segments_N`` file
    from ``SegmentInfos.to_json()``), as the card's 1M-doc pass makes it,
    opens in the port's reader and in the JAX package's."""
    from diagon_tpu.index.reader import DirectoryReader as JaxReader

    d = FSDirectory(tmp_path)
    segs = [segment_from_jax(_jax_segment(30, 5, "_0")),
            segment_from_jax(_jax_segment(20, 6, "_1", delete_every=4))]
    infos = SegmentInfos(generation=1, counter=2)
    for s in segs:
        files = write_segment(d, s)
        infos.segments.append(SegmentInfo(
            s.name, s.num_docs, files, s.num_docs - s.num_live_docs))
    d.write_bytes(_gen_name(1), json.dumps(infos.to_json()).encode())
    assert _gen_name(1) == "segments_1" and _parse_gen("segments_z") == 35
    assert find_latest_commit_gen(d) == 1
    assert read_segment_infos(d).total_docs() == 50

    r = DirectoryReader.open(d, verify_checksums=True)
    assert r.generation == 1 and r.max_doc() == 50
    assert r.num_docs() == 50 - segs[1].num_docs + segs[1].num_live_docs
    assert [leaf.doc_base for leaf in r.leaves()] == [0, 30]
    assert isinstance(r.leaves()[1].reader, SegmentReader)
    assert r.document(31) == segs[1].stored[1]
    assert r.document(999) == {}
    j = JaxReader.open(jstore.FSDirectory(tmp_path), verify_checksums=True)
    for a, b in zip(j.segments_data(), r.segments_data()):
        _assert_segments_equal(b, a)

    # a newer generation is what reopen sees
    infos.generation = 2
    infos.segments = infos.segments[:1]
    d.write_bytes(_gen_name(2), json.dumps(infos.to_json()).encode())
    r2 = r.reopen()
    assert r2.generation == 2 and r2.max_doc() == 30
    assert r.max_doc() == 50  # the old snapshot is unchanged
    assert read_segment_infos(RAMDirectory()).segments == []


# ---------------------------------------------------------------------------
# A JAX-committed index served by the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    """Three segments and deletes, committed by the JAX IndexWriter."""
    from diagon_tpu.index.writer import IndexWriter, IndexWriterConfig

    path = tmp_path_factory.mktemp("committed")
    rng = np.random.Generator(np.random.PCG64(2031))
    w = IndexWriter(jstore.FSDirectory(path),
                    IndexWriterConfig(max_buffered_docs=400,
                                      merge_scheduler="serial",
                                      commit_on_close=True))
    for i in range(1100):
        w.add_document(_doc(rng, i))
        if i == 650:
            w.commit()
    w.delete_documents("tag", "t3")
    w.delete_documents("body", "w17")
    w.commit()
    w.close()
    return path


def _queries():
    from diagon_tpu.search.query import (
        BooleanClause,
        BooleanQuery,
        NumericRangeQuery,
        Occur,
        PhraseQuery,
        PointRangeQuery,
        TermQuery,
    )

    def B(*cl, min_should=0):
        return BooleanQuery([BooleanClause(q, o) for q, o in cl], min_should)

    M, S, F, N = Occur.MUST, Occur.SHOULD, Occur.FILTER, Occur.MUST_NOT
    T = TermQuery
    return {
        "term": T("body", "oil"),
        "term_title": T("title", "w3"),
        "and": B((T("body", "oil"), M), (T("body", "price"), M)),
        "or": B(*[(T("body", f"w{i}"), S) for i in range(0, 32, 3)]),
        "must_not": B((T("body", "trade"), M), (T("body", "w2"), N),
                      (T("body", "w5"), S)),
        "range_filter": B((T("body", "w1"), M),
                          (NumericRangeQuery("views", 20, 60), F)),
        "range_must_not": B((T("body", "price"), S), (T("body", "w9"), S),
                            (PointRangeQuery("ts", None, 300), N)),
        "phrase": PhraseQuery("body", ["w1", "w2"]),
        "phrase_in_boolean": B((PhraseQuery("body", ["oil", "w4"]), S),
                               (T("body", "trade"), S)),
    }


@pytest.fixture(scope="module")
def served(committed):
    from diagon_tpu.index.reader import DirectoryReader as JaxReader
    from diagon_tpu.search.searcher import IndexSearcher as JaxSearcher
    from diagon_tpu_torch.search import IndexSearcher

    jr = JaxReader.open(jstore.FSDirectory(committed))
    tr = DirectoryReader.open(FSDirectory(committed), verify_checksums=True)
    with warnings.catch_warnings():
        # a read-only view reaching torch.from_numpy warns: a defect here
        warnings.simplefilter("error")
        port = IndexSearcher(tr, device="cpu")
    return jr, tr, port, JaxSearcher(jr)


def test_the_committed_index_has_segments_and_deletes(served):
    jr, tr, _, _ = served
    assert len(tr.leaves()) >= 3
    assert tr.num_docs() < tr.max_doc() == 1100
    assert (tr.num_docs(), tr.generation) == (jr.num_docs(), jr.generation)
    assert [s.live_docs is not None for s in tr.segments_data()] == [
        s.live_docs is not None for s in jr.segments_data()]


@pytest.mark.parametrize("name", list(_queries()))
def test_served_from_disk_as_the_jax_searcher(served, name):
    _, _, port, jax_s = served
    q = _queries()[name]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = port.search(query_from_jax(q), k=10)
    want = jax_s.search(q, k=10)
    assert got.total_hits == want.total_hits, name
    assert got.total_hits > 0, name
    assert got.doc_ids() == want.doc_ids(), name
    np.testing.assert_array_equal(
        np.float32(got.scores()).view(np.uint32),
        np.float32(want.scores()).view(np.uint32), err_msg=name)


def test_a_batch_served_from_disk_as_the_jax_searcher(served):
    _, _, port, jax_s = served
    # one field a batch, and no bare phrase (the port's rule and JAX's)
    qs = [q for n, q in _queries().items() if n not in ("phrase",
                                                        "term_title")]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = port.search_batch([query_from_jax(q) for q in qs], k=10)
    want = jax_s.search_batch(qs, k=10)
    for g, w in zip(got, want):
        assert (g.total_hits, g.doc_ids()) == (w.total_hits, w.doc_ids())
        np.testing.assert_array_equal(
            np.float32(g.scores()).view(np.uint32),
            np.float32(w.scores()).view(np.uint32))


def test_positions_of_a_loaded_index_wait_for_a_phrase(committed):
    """A segment read from disk reaches the phrase path with its positions
    still undecoded; the first phrase decodes and uploads them."""
    from diagon_tpu_torch.search import IndexSearcher
    from diagon_tpu_torch.search.query import PhraseQuery

    r = DirectoryReader.open(FSDirectory(committed))
    s = IndexSearcher(r, device="cpu")
    pps = [seg.fields["body"].postings for seg in r.segments_data()]
    assert all(pp.pos_start is None and pp.pos_loader is not None
               for pp in pps)
    assert s.search(PhraseQuery("body", ["w1", "w2"]), k=5).total_hits > 0
    assert all(pp.pos_start is not None for pp in pps)
