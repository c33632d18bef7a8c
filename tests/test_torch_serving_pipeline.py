"""The port's serving-pipeline contract, mirroring
``tests/unit/test_serving_pipeline.py`` on the CPU.

``dispatch_batch`` returns handles whose fused rows stay tensors on the
searcher's device (no host copy), any number of batches may be in flight,
and collecting them (one at a time, out of order, or many at once) gives
``search_batch``'s results bit for bit. A fifth case runs the same contract
on the small-batch tile-UB route: pruning forced onto the small segment and
batches of fewer than ``approx_min_q`` pure-OR queries.
"""

import numpy as np
import pytest
import torch

from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu_torch.search import IndexSearcher
from diagon_tpu_torch.search.convert import segment_from_jax
from diagon_tpu_torch.search.query import (
    BooleanClause,
    BooleanQuery,
    Occur,
    TermQuery,
)


def _segment():
    rng = np.random.Generator(np.random.PCG64(3))
    words = np.asarray(
        [f"w{i}" for i in range(40)] + ["oil", "price", "trade"],
        dtype=object,
    )
    mem = MemoryIndex()
    for _ in range(600):
        ln = max(3, int(rng.normal(18, 6)))
        mem.add_document(
            Document().add(TextField("body", " ".join(rng.choice(words, ln))))
        )
    return segment_from_jax(flush_memory_index(mem, "_pipe"))


@pytest.fixture(scope="module")
def searcher():
    return IndexSearcher([_segment()], device="cpu")


@pytest.fixture(scope="module")
def tile_ub_searcher():
    """Pruning forced onto the 600-doc segment; batches below
    approx_min_q (8) of pure-OR plans take the tile-UB route."""
    s = IndexSearcher([_segment()], device="cpu")
    for ex in s._ctx("body").row_executors:
        ex.prune_min_docs = 0
        ex.prune_solo_min_docs = 0
    return s


def _batches(n):
    outs = []
    for i in range(n):
        outs.append([
            TermQuery("body", f"w{(3 * i) % 40}"),
            BooleanQuery([
                BooleanClause(TermQuery("body", "oil"), Occur.SHOULD),
                BooleanClause(TermQuery("body", f"w{i % 40}"), Occur.SHOULD),
            ]),
            BooleanQuery([
                BooleanClause(TermQuery("body", "trade"), Occur.MUST),
                BooleanClause(TermQuery("body", f"w{(7 * i) % 40}"),
                              Occur.SHOULD),
            ]),
        ])
    return outs


def _or_batches(n):
    """Batches of 2-7 distinct pure-OR queries."""
    outs = []
    for i in range(n):
        batch = []
        for j in range(2 + i % 6):
            terms = [f"w{(5 * i + 7 * j) % 40}", "oil",
                     f"w{(11 * j + i) % 40}"]
            batch.append(BooleanQuery([
                BooleanClause(TermQuery("body", t), Occur.SHOULD)
                for t in terms[: 1 + (i + j) % 3]
            ]))
        outs.append(batch)
    return outs


def _assert_same(got, want):
    assert [t.doc_ids() for t in got] == [t.doc_ids() for t in want]
    assert [t.total_hits for t in got] == [t.total_hits for t in want]
    for g, w in zip(got, want):
        a = np.asarray([d.score for d in g.score_docs], np.float32)
        b = np.asarray([d.score for d in w.score_docs], np.float32)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_dispatch_returns_device_resident_handles(searcher):
    h = searcher.dispatch_batch(_batches(1)[0], 5)
    nq, k, parts = h
    assert nq == 3 and parts
    for _si, _kk, fused, _ex, _plans in parts:
        # the async contract: no host materialisation at dispatch time
        assert isinstance(fused, torch.Tensor)
        assert not isinstance(fused, np.ndarray)
        assert fused.device == torch.device("cpu")


def test_depth_n_in_flight_then_collect_many(searcher):
    batches = _batches(6)
    want = [searcher.search_batch(b, 5) for b in batches]
    handles = [searcher.dispatch_batch(b, 5) for b in batches]
    got = searcher.collect_many(handles)
    assert len(got) == len(batches)
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_out_of_order_collection(searcher):
    a, b = _batches(2)
    ha = searcher.dispatch_batch(a, 5)
    hb = searcher.dispatch_batch(b, 5)
    got_b = searcher.collect_batch(hb)  # collect LIFO
    got_a = searcher.collect_batch(ha)
    _assert_same(got_b, searcher.search_batch(b, 5))
    _assert_same(got_a, searcher.search_batch(a, 5))


def test_interleaved_dispatch_collect(searcher):
    batches = _batches(4)
    want = [searcher.search_batch(b, 5) for b in batches]
    h0 = searcher.dispatch_batch(batches[0], 5)
    h1 = searcher.dispatch_batch(batches[1], 5)
    _assert_same(searcher.collect_batch(h0), want[0])
    h2 = searcher.dispatch_batch(batches[2], 5)
    _assert_same(searcher.collect_batch(h1), want[1])
    h3 = searcher.dispatch_batch(batches[3], 5)
    got = searcher.collect_many([h2, h3])
    _assert_same(got[0], want[2])
    _assert_same(got[1], want[3])


def test_tile_ub_route_keeps_the_contract(tile_ub_searcher, searcher):
    """Handles of the tile-UB route ([Q, 2k+2] rows on the device) in
    flight together, collected out of order and many at once: equal to
    search_batch, and to the exhaustive route of the unforced searcher."""
    s = tile_ub_searcher
    ex = s._ctx("body").row_executors[0]
    batches = _or_batches(6)
    want = [s.search_batch(b, 5) for b in batches]
    before = ex.metrics["pruned"].value()
    handles = [s.dispatch_batch(b, 5) for b in batches]
    assert ex.metrics["pruned"].value() - before == len(batches)
    for _, _, parts in handles:
        for _si, _kk, fused, _ex, plans in parts:
            assert isinstance(fused, torch.Tensor)
            assert fused.shape[-1] == 2 * 5 + 2
            assert len({id(p) for p in plans}) == len(plans)  # no dedup
            assert not ex._entry(plans).compact_built  # not the batch route
    _assert_same(s.collect_batch(handles[3]), want[3])
    got = s.collect_many(handles[:3] + handles[4:])
    for g, w in zip(got, want[:3] + want[4:]):
        _assert_same(g, w)
    for b, w in zip(batches, want):
        _assert_same(w, searcher.search_batch(b, 5))
