"""Row-bank build of diagon_tpu_torch against the JAX package's, bit for
bit, on the same segment: heavy bank, row maps, host rows, light banks,
the padded doc axis, and the state carried across by ``convert.py``. The
segment is built with the JAX package and carried into the port by
``convert.segment_from_jax``."""

import numpy as np
import pytest

from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search.query import BooleanClause, BooleanQuery, Occur, TermQuery
from diagon_tpu.search.searcher import IndexSearcher as JaxSearcher
from diagon_tpu_torch.ops import bank_decode
from diagon_tpu_torch.search import IndexSearcher, row_engine as tre
from diagon_tpu_torch.search.convert import (
    query_from_jax,
    row_field_index_from_state,
    segment_from_jax,
)

N_DOCS = 1500


@pytest.fixture(scope="module")
def seg():
    rng = np.random.Generator(np.random.PCG64(11))
    vocab = np.asarray([f"w{i}" for i in range(80)] + ["oil", "price"],
                       dtype=object)
    mem = MemoryIndex()
    for i in range(N_DOCS):
        words = list(rng.choice(vocab, size=int(rng.integers(5, 40))))
        words += ["common"] * int(rng.integers(1, 4))  # heavy, freq > 1
        if i % 97 == 0:
            words.append("rareterm")  # light
        mem.add_document(Document().add(TextField("body", " ".join(words))))
    s = flush_memory_index(mem, "_bank")
    for d in range(0, N_DOCS, 13):
        s.delete_document(d)
    return s


@pytest.fixture(scope="module")
def pair(seg):
    """(JAX row executor, port row executor) for field body."""
    js = JaxSearcher([seg])
    ts = IndexSearcher([segment_from_jax(seg)], device="cpu")
    return js._ctx("body").row_executors[0], ts._ctx("body").row_executors[0]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_heavy_bank_and_row_maps_equal(pair):
    jex, tex = pair
    ji, ti = jex.index, tex.index
    H = len(ji.heavy_tid_of_row)
    assert H >= 3  # w*, common: the bank is not trivially empty
    np.testing.assert_array_equal(ti.heavy_row_of_term, ji.heavy_row_of_term)
    np.testing.assert_array_equal(ti.heavy_tid_of_row, ji.heavy_tid_of_row)
    np.testing.assert_array_equal(_bits(ti.heavy_weight), _bits(ji.heavy_weight))
    assert tuple(ti.heavy_bank.shape) == (H, ji.num_docs_pad)
    np.testing.assert_array_equal(
        _bits(ti.heavy_bank.numpy()), _bits(np.asarray(ji.heavy_bank)[:H])
    )
    np.testing.assert_array_equal(_bits(ti.live.numpy()), _bits(ji.live))


def test_padded_doc_axis_equal(seg):
    js = JaxSearcher([seg])
    ts = IndexSearcher([segment_from_jax(seg)], device="cpu")
    assert ts.device_segments[0].num_docs_pad == js.device_segments[0].num_docs_pad
    jf = js.device_segments[0].fields["body"]
    tf = ts.device_segments[0].fields["body"]
    for name in ("block_base", "block_count", "block_doc_bits", "norms",
                 "block_word_off", "block_term", "block_entry_start"):
        np.testing.assert_array_equal(
            getattr(tf, name).numpy(), np.asarray(getattr(jf, name))
        )
    np.testing.assert_array_equal(
        tf.packed.numpy().view(np.uint32), np.asarray(jf.packed)
    )
    from diagon_tpu.search.device_index import collection_stats as jstats
    from diagon_tpu_torch.search.device_index import collection_stats

    for field in ("body", "absent"):
        assert collection_stats(ts.device_segments, field, ts.max_doc) == jstats(
            js.device_segments, field, js.max_doc
        )


def test_positions_upload_is_deferred(seg):
    ts = IndexSearcher([segment_from_jax(seg)], device="cpu")
    f = ts.device_segments[0].fields["body"]
    assert f.positions is None
    f.ensure_positions()
    pp = seg.fields["body"].postings
    np.testing.assert_array_equal(f.pos_start.numpy(), pp.pos_start)
    np.testing.assert_array_equal(f.positions.numpy(), pp.positions)


@pytest.mark.parametrize("term", ["common", "w3", "rareterm", "oil"])
def test_host_row_equal(pair, seg, term):
    jex, tex = pair
    tid = seg.fields["body"].postings.term_id(term)
    w = np.float32(1.7)
    np.testing.assert_array_equal(
        _bits(tex.index.host_row(tid, w)), _bits(jex.index.host_row(tid, w))
    )


def _light_specs(seg, D):
    pp = seg.fields["body"].postings
    specs = [
        (1, pp.term_id("rareterm"), np.float32(2.25)),
        (2, pp.term_id("common"), np.float32(0.5)),  # boosted heavy term
        (3, pp.term_id("w7"), np.float32(1.0)),
    ]
    host = np.zeros(D, np.float32)
    host[::5] = 1.0
    return specs, [(4, host)]


@pytest.mark.parametrize("chunk", [None, 7])
def test_light_bank_equals_jax_and_host_rows(pair, seg, chunk, monkeypatch):
    """Device-decoded light rows equal the JAX light bank and host_row;
    chunk=7 forces the chunked decode over many steps."""
    if chunk is not None:
        monkeypatch.setattr(bank_decode, "_REFERENCE_CHUNK_BLOCKS", chunk)
    jex, tex = pair
    specs, host_rows = _light_specs(seg, tex.index.num_docs_pad)
    want = np.asarray(jex._build_light_bank(4, specs, host_rows))
    got = tex._build_light_bank(4, specs, host_rows).numpy()
    assert got.shape == (5, tex.index.num_docs_pad)
    np.testing.assert_array_equal(_bits(got), _bits(want[:5]))
    assert not got[0].any()  # row 0 stays the zero row
    for r, tid, w in specs:
        np.testing.assert_array_equal(
            _bits(got[r]), _bits(tex.index.host_row(tid, w))
        )


def test_chunked_heavy_bank_build_equal(seg, pair, monkeypatch):
    monkeypatch.setattr(bank_decode, "_REFERENCE_CHUNK_BLOCKS", 5)
    ts = IndexSearcher([segment_from_jax(seg)], device="cpu")
    bank = ts._ctx("body").row_executors[0].index.heavy_bank
    np.testing.assert_array_equal(
        _bits(bank.numpy()), _bits(pair[1].index.heavy_bank.numpy())
    )


def test_on_demand_size_is_not_served(seg, pair, monkeypatch):
    """At ON_DEMAND_MIN_DOCS and more no resident heavy bank is served:
    the heavy terms are classified as in resident mode, and their rows are
    built per batch (tests/test_torch_on_demand.py)."""
    monkeypatch.setattr(tre.RowFieldIndex, "ON_DEMAND_MIN_DOCS", 1024)
    ts = IndexSearcher([segment_from_jax(seg)], device="cpu")
    idx = ts._ctx("body").row_executors[0].index
    assert idx.bank_on_demand and idx.heavy_bank is None
    resident = pair[1].index
    np.testing.assert_array_equal(idx.heavy_tid_of_row,
                                  resident.heavy_tid_of_row)
    np.testing.assert_array_equal(_bits(idx.heavy_weight),
                                  _bits(resident.heavy_weight))


def _queries():
    t = lambda w, b=1.0: TermQuery("body", w, boost=b)  # noqa: E731
    return [
        t("common"),
        t("rareterm"),
        BooleanQuery([BooleanClause(t(f"w{i}"), Occur.SHOULD)
                      for i in range(0, 40, 3)]),
        BooleanQuery([BooleanClause(t("oil"), Occur.MUST),
                      BooleanClause(t("price", 2.0), Occur.SHOULD),
                      BooleanClause(t("w5"), Occur.MUST_NOT)]),
    ]


def test_convert_scores_identically(pair, seg):
    """The JAX index's state, carried into a port index, scores every plan
    exactly as the JAX executor does."""
    jex, _ = pair
    ji = jex.index
    state = {
        "heavy_bank": np.asarray(ji.heavy_bank),
        "heavy_row_of_term": ji.heavy_row_of_term,
        "heavy_tid_of_row": ji.heavy_tid_of_row,
        "heavy_weight": ji.heavy_weight,
        "live": np.asarray(ji.live),
        "tf_lut_host": ji.tf_lut_host,
    }
    fd = seg.fields["body"]
    idx = row_field_index_from_state(fd.postings, fd.norms, state, "cpu")
    ex = tre.RowExecutor(idx)
    js = JaxSearcher([seg])
    ts = IndexSearcher([segment_from_jax(seg)], device="cpu")
    jplans, tplans = [], []
    for q in _queries():
        field, clauses, ms = js._term_clauses(q)
        jplans.append(js._row_plans(field, clauses, ms)[0])
        field, clauses, ms = ts._term_clauses(query_from_jax(q))
        tps = ts._clause_term_plans(field, clauses)[0]
        tplans.append(ex.build_plan(tps, ms, ts._ctx("body").row_executors[0].idf_of_tid))
    want = js._ctx("body").row_executors[0].top_k_batch(jplans, 10)
    got = ex.top_k_batch(tplans, 10)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(ex.count_batch(tplans), want[2])


def test_convert_rejects_inconsistent_state(pair, seg):
    ji = pair[0].index
    fd = seg.fields["body"]
    state = {"heavy_bank": np.zeros((1, 1024), np.float32),
             "heavy_row_of_term": ji.heavy_row_of_term,
             "heavy_tid_of_row": ji.heavy_tid_of_row,
             "heavy_weight": ji.heavy_weight,
             "live": np.asarray(ji.live), "tf_lut_host": ji.tf_lut_host}
    with pytest.raises(ValueError):
        row_field_index_from_state(fd.postings, fd.norms, state, "cpu")
    del state["live"]
    with pytest.raises(KeyError):
        row_field_index_from_state(fd.postings, fd.norms, state, "cpu")
