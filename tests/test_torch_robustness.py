"""Robustness and lifecycle through the port's API and writer: the six
cases of ``tests/integration/test_robustness.py`` (crash recovery by
generation, a corrupt manifest, a corrupt segment under checksums, search
during concurrent merges, a phrase across a merge, a Unicode round trip),
with the phrase and Unicode answers held against the JAX package's."""

import json
import threading

import pytest

import diagon_tpu.api as jdg
import diagon_tpu_torch.api as dg
from diagon_tpu.document import Document as JDocument
from diagon_tpu.document import TextField as JTextField
from diagon_tpu.index.reader import DirectoryReader as JDirectoryReader
from diagon_tpu.index.writer import IndexWriter as JIndexWriter
from diagon_tpu.index.writer import IndexWriterConfig as JIndexWriterConfig
from diagon_tpu.search.query import PhraseQuery as JPhraseQuery
from diagon_tpu.search.searcher import IndexSearcher as JIndexSearcher
from diagon_tpu.store import FSDirectory as JFSDirectory
from diagon_tpu_torch.document import Document, TextField
from diagon_tpu_torch.index.merge import TieredMergePolicy
from diagon_tpu_torch.index.reader import DirectoryReader
from diagon_tpu_torch.index.writer import IndexWriter, IndexWriterConfig
from diagon_tpu_torch.search import IndexSearcher
from diagon_tpu_torch.search.oracle import OracleSearcher
from diagon_tpu_torch.search.query import PhraseQuery, TermQuery
from diagon_tpu_torch.store import FSDirectory


def test_crash_recovery_ignores_partial_state(tmp_path):
    """A torn post-commit state (stray segment files, tmp manifests) must
    not corrupt reopen: readers use the latest complete generation."""
    path = tmp_path / "idx"
    d = FSDirectory(path)
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(Document().add(TextField("body", "committed oil")))
        w.commit()

    # a crash mid-flush after the commit: a stray uncommitted segment
    # bundle and a torn manifest tmp file
    d.write_bytes("_zz.bnd", b"garbage-partial-write")
    (path / "segments_zz.tmp").write_bytes(b"{not json")

    r = DirectoryReader.open(d)
    assert r.max_doc() == 1
    s = OracleSearcher(r.segments_data())
    assert s.search(TermQuery("body", "committed"), 5).total_hits == 1
    s = dg.open_searcher(dg.open_index_reader(str(path)), device="cpu")
    assert dg.count(s, dg.term_query("body", "committed")) == 1


def test_corrupt_manifest_is_detected(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(Document().add(TextField("body", "x")))
        w.commit()
    gen = [f for f in d.list_files() if f.startswith("segments_")][0]
    d.write_bytes(gen, b"{broken")
    with pytest.raises(json.JSONDecodeError):
        DirectoryReader.open(d)
    assert dg.pcall(dg.open_index_reader, str(tmp_path / "idx")) is None
    assert dg.last_error().startswith("JSONDecodeError")


def test_corrupt_segment_detected_with_checksums(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    with IndexWriter(d, IndexWriterConfig(merge_scheduler="serial")) as w:
        w.add_document(Document().add(TextField("body", "x y z")))
        w.commit()
    bnd = [f for f in d.list_files() if f.endswith(".bnd")][0]
    raw = bytearray(d.read_bytes(bnd))
    raw[len(raw) // 2] ^= 0xFF
    d.write_bytes(bnd, bytes(raw))
    with pytest.raises(IOError):
        DirectoryReader.open(d, verify_checksums=True)


def test_search_during_concurrent_merges(tmp_path):
    """Readers opened before and during merges keep working (immutable
    segments); a post-merge reader sees everything."""
    d = FSDirectory(tmp_path / "idx")
    cfg = IndexWriterConfig(
        max_buffered_docs=5,
        merge_scheduler="concurrent",
        merge_policy=TieredMergePolicy(segs_per_tier=2, max_merge_at_once=4),
    )
    w = IndexWriter(d, cfg)
    errors = []

    def reader_loop():
        try:
            for _ in range(20):
                try:
                    r = DirectoryReader.open(d)
                except FileNotFoundError:
                    continue
                s = OracleSearcher(r.segments_data())
                s.search(TermQuery("body", "oil"), 5)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=reader_loop)
    for i in range(60):
        w.add_document(Document().add(TextField("body", f"oil doc {i} w{i}")))
        if i == 10:
            w.commit()
            t.start()
        elif i % 15 == 0 and i:
            w.commit()
    w.commit()
    w.wait_for_merges()
    w.commit_merge_results()
    w.close()
    t.join()
    assert not errors, errors

    r = DirectoryReader.open(d)
    assert r.max_doc() == 60
    s = OracleSearcher(r.segments_data())
    assert s.search(TermQuery("body", "oil"), 5).total_hits == 60
    s = IndexSearcher(r, device="cpu")
    assert s.search(TermQuery("body", "oil"), 5).total_hits == 60


TEXTS = ["the oil price rose", "price of oil", "oil price shock",
         "water price", "crude oil", "oil price oil price"]


def test_phrase_survives_merge(tmp_path):
    d = FSDirectory(tmp_path / "idx")
    cfg = IndexWriterConfig(max_buffered_docs=2, merge_scheduler="serial")
    with IndexWriter(d, cfg) as w:
        for t in TEXTS:
            w.add_document(Document().add(TextField("body", t)))
        w.flush()
        assert w.segment_count >= 3
        w.force_merge(1)
        w.commit()
    r = DirectoryReader.open(d)
    dev = IndexSearcher(r, device="cpu")
    oracle = OracleSearcher(r.segments_data())
    q = PhraseQuery("body", ["oil", "price"])
    want, got = oracle.search(q, 10), dev.search(q, 10)
    assert want.doc_ids() == got.doc_ids()
    assert sorted(got.doc_ids()) == [0, 2, 5]

    jd = JFSDirectory(tmp_path / "jax")
    jcfg = JIndexWriterConfig(max_buffered_docs=2, merge_scheduler="serial")
    with JIndexWriter(jd, jcfg) as w:
        for t in TEXTS:
            w.add_document(JDocument().add(JTextField("body", t)))
        w.flush()
        w.force_merge(1)
        w.commit()
    jres = JIndexSearcher(JDirectoryReader.open(jd)).search(
        JPhraseQuery("body", ["oil", "price"]), 10)
    assert [(sd.doc, sd.score) for sd in got.score_docs] == [
        (sd.doc, sd.score) for sd in jres.score_docs]


def _unicode(api, path):
    w = api.open_writer(path)
    api.add_document(w, {"body": "café au lait prices rose"})
    api.add_document(w, {"body": "crude oil price データ 上昇"})
    api.commit(w)
    api.close_writer(w)
    kw = {"device": "cpu"} if api is dg else {}
    s = api.open_searcher(api.open_reader(path), **kw)
    return [(api.count(s, api.term_query("body", t)),
             api.search(s, api.term_query("body", t)))
            for t in ("café", "データ", "price", "上昇")]


def test_unicode_round_trip(tmp_path):
    got = _unicode(dg, str(tmp_path / "port"))
    assert got == _unicode(jdg, str(tmp_path / "jax"))
    assert [c for c, _ in got[:3]] == [1, 1, 1]
