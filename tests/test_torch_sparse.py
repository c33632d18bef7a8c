"""The port's sparse-vector index and searcher (device cpu) against the
JAX package's (``diagon_tpu.sparse``, Pallas in interpret mode where it
reaches a kernel) and the oracles: the same packed blocks, scales and
exact CSR from one build, and the same docids, f32 score bits and hits
from every search method. Mirrors the cases of
``tests/unit/test_sparse.py``. The searcher's vectorised row plans are
held field for field against the per-clause construction (``TermPlan``s
through ``RowExecutor.build_plan``)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from diagon_tpu.sparse import SparseIndex as JaxIndex
from diagon_tpu.sparse import SparseSearcher as JaxSearcher
from diagon_tpu.sparse import SparseVector as JaxVector
from diagon_tpu_torch.codecs.postings import PackedPostings, decode_block_numpy
from diagon_tpu_torch.observability.metrics import registry
from diagon_tpu_torch.search.engine import TermPlan
from diagon_tpu_torch.search.row_engine import _bucket_tq
from diagon_tpu_torch.search.convert import (
    sparse_index_from_jax,
    sparse_vector_from_jax,
)
from diagon_tpu_torch.sparse import SparseIndex, SparseSearcher, SparseVector


def _random_pairs(rng, n_docs, vocab=500, nnz=30):
    """(ids, values) pairs, drawn as tests/unit/test_sparse.py draws them."""
    out = []
    for _ in range(n_docs):
        k = int(rng.integers(5, nnz))
        ids = np.sort(rng.choice(vocab, size=k, replace=False))
        vals = rng.random(k).astype(np.float32) * 3 + 0.01
        out.append((ids, vals))
    return out


def _fuzz_pairs(rng, n_docs, vocab, lo, hi, scale, offset):
    out = []
    for _ in range(n_docs):
        nnz = int(rng.integers(lo, hi))
        ids = rng.choice(vocab, nnz, replace=False)
        vals = (rng.random(nnz) * scale + offset).astype(np.float32)
        out.append((ids, vals))
    return out


def _both(pairs):
    """(port index, JAX index) built from the same vectors."""
    return (SparseIndex.build([SparseVector(i, v) for i, v in pairs]),
            JaxIndex.build([JaxVector(i, v) for i, v in pairs]))


def _same(got, want, what=""):
    gs, gd, gh = got
    ws, wd, wh = want
    assert int(gh) == int(wh), what
    np.testing.assert_array_equal(np.asarray(gd), np.asarray(wd),
                                  err_msg=str(what))
    np.testing.assert_array_equal(
        np.asarray(gs, np.float32).view(np.uint32),
        np.asarray(ws, np.float32).view(np.uint32), err_msg=str(what))


def test_sparse_vector_dot():
    a = SparseVector([1, 5, 9], [1.0, 2.0, 3.0])
    b = SparseVector([5, 9, 11], [10.0, 1.0, 7.0])
    assert a.dot(b) == 23.0
    assert len(a) == 3


def test_sparse_vector_sorts():
    v = SparseVector([9, 1], [2.0, 1.0])
    np.testing.assert_array_equal(v.ids, [1, 9])
    np.testing.assert_array_equal(v.values, [1.0, 2.0])
    w = sparse_vector_from_jax(JaxVector([9, 1], [2.0, 1.0]))
    np.testing.assert_array_equal(w.ids, v.ids)
    np.testing.assert_array_equal(w.values, v.values)


def test_build_matches_jax():
    """The vectorised build packs the JAX build's blocks (terms in string
    order), with its scales and exact CSR."""
    rng = np.random.Generator(np.random.PCG64(3))
    port, jax_idx = _both(_random_pairs(rng, 300, vocab=1200))
    got = port.segment.fields["_sparse"]
    want = jax_idx.segment.fields["_sparse"]
    for f in dataclasses.fields(PackedPostings):
        a, b = getattr(got.postings, f.name), getattr(want.postings, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(got.norms, want.norms)
    assert port.num_docs == jax_idx.num_docs
    assert port.scales == jax_idx.scales
    assert port.exact.keys() == jax_idx.exact.keys()
    for key, (d, w) in jax_idx.exact.items():
        np.testing.assert_array_equal(port.exact[key][0], d)
        np.testing.assert_array_equal(port.exact[key][1].view(np.uint32),
                                      w.view(np.uint32))


def test_quantization_error_bounded():
    rng = np.random.Generator(np.random.PCG64(3))
    pairs = _random_pairs(rng, 200)
    idx = SparseIndex.build([SparseVector(i, v) for i, v in pairs])
    pp = idx.segment.fields["_sparse"].postings
    for tid, term in enumerate(pp.terms[:50]):
        scale = idx.scales[term]
        for b in range(int(pp.block_start[tid]), int(pp.block_start[tid + 1])):
            docs, bins = decode_block_numpy(pp, b)
            for d, bn in zip(docs, bins):
                ids, vals = pairs[d]
                orig = dict(zip(ids, vals))[int(term)]
                assert abs(bn * scale - orig) <= scale * 0.5 + 1e-6


def test_device_matches_quantized_oracle():
    rng = np.random.Generator(np.random.PCG64(4))
    port, jax_idx = _both(_random_pairs(rng, 600))
    searcher = SparseSearcher(port, device="cpu")
    jax_s = JaxSearcher(jax_idx)
    for qseed in range(3):
        qrng = np.random.Generator(np.random.PCG64(100 + qseed))
        ids, vals = _random_pairs(qrng, 1, nnz=12)[0]
        q = SparseVector(ids, vals)
        got = searcher.search(q, 10)
        _same(got, searcher.search_oracle(q, 10), "vs oracle")
        _same(got, jax_s.search(JaxVector(ids, vals), 10), "vs jax")


def test_quantized_topk_close_to_exact():
    """Quantized top-10 tracks the exact dot-product top-10 closely."""
    rng = np.random.Generator(np.random.PCG64(9))
    pairs = _random_pairs(rng, 400)
    searcher = SparseSearcher(
        SparseIndex.build([SparseVector(i, v) for i, v in pairs]),
        device="cpu")
    q = SparseVector(*_random_pairs(np.random.Generator(np.random.PCG64(77)),
                                    1)[0])
    exact = np.asarray([q.dot(SparseVector(i, v)) for i, v in pairs])
    exact_top = set(np.argsort(-exact)[:10].tolist())
    _, dd, _ = searcher.search(q, 10)
    assert len(exact_top & set(int(d) for d in dd)) >= 8


def test_missing_terms_query():
    pairs = _random_pairs(np.random.Generator(np.random.PCG64(5)), 50)
    searcher = SparseSearcher(
        SparseIndex.build([SparseVector(i, v) for i, v in pairs]),
        device="cpu")
    scores, docs, hits = searcher.search(SparseVector([99999], [1.0]), 10)
    assert hits == 0 and len(scores) == 0 and len(docs) == 0


def test_search_batch_matches_single():
    rng = np.random.Generator(np.random.PCG64(11))
    port, jax_idx = _both(_random_pairs(rng, 300))
    searcher = SparseSearcher(port, device="cpu")
    qp = _random_pairs(np.random.Generator(np.random.PCG64(12)), 5, nnz=15)
    qp.append((np.asarray([999999]), np.asarray([1.0], np.float32)))
    qs = [SparseVector(i, v) for i, v in qp]
    batch = searcher.search_batch(qs, 10)
    want = JaxSearcher(jax_idx).search_batch([JaxVector(i, v) for i, v in qp],
                                             10)
    for q, b, w in zip(qs, batch, want):
        _same(b, searcher.search(q, 10), "batch vs single")
        _same(b, w, "batch vs jax")
    # dispatch_batch + collect_batch is the same call in two halves, and
    # a re-issued batch gives the same answers
    for _ in range(2):
        handle = searcher.dispatch_batch(qs, 10)
        for b, c in zip(batch, searcher.collect_batch(handle)):
            _same(c, b, "collect_batch")


def test_dispatch_and_collect_keep_no_query_alive():
    """The searcher keeps nothing of a batch's query objects once the
    caller drops them: plans are built from each query's content."""
    import gc
    import weakref

    pairs = _random_pairs(np.random.Generator(np.random.PCG64(13)), 200)
    searcher = SparseSearcher(
        SparseIndex.build([SparseVector(i, v) for i, v in pairs]),
        device="cpu")
    qp = _random_pairs(np.random.Generator(np.random.PCG64(14)), 4, nnz=15)
    qs = [SparseVector(i, v) for i, v in qp]
    refs = [weakref.ref(q) for q in qs]
    got = searcher.collect_batch(searcher.dispatch_batch(qs, 10))
    assert len(got) == len(qs) and all(h > 0 for _, _, h in got)
    del qs
    gc.collect()
    assert [r() for r in refs] == [None] * len(refs)


def test_alpha_clause_pruning():
    """alpha < 1 prunes low-gain clauses; ranking stays close to exact;
    both packages prune the same clauses."""
    rng = np.random.Generator(np.random.PCG64(21))
    port, jax_idx = _both(_random_pairs(rng, 400))
    searcher = SparseSearcher(port, device="cpu")
    jax_s = JaxSearcher(jax_idx)
    ids, vals = _random_pairs(np.random.Generator(np.random.PCG64(22)), 1,
                              nnz=25)[0]
    q = SparseVector(ids, vals)
    full = searcher.search(q, 10, alpha=1.0)
    part = searcher.search(q, 10, alpha=0.8)
    assert len(part[1]) == len(full[1])
    assert len(set(int(d) for d in full[1]) & set(int(d) for d in part[1])) >= 7
    _same(full, searcher.search_oracle(q, 10), "alpha 1 vs oracle")
    _same(part, jax_s.search(JaxVector(ids, vals), 10, alpha=0.8),
          "alpha 0.8 vs jax")


def test_rerank_exact_parity_fuzz():
    """search_rerank equals brute-force exact search bit for bit (docids,
    f32 scores, hits) on fuzzed corpora; a tiny R forces the certificate
    and its escalation."""
    rng = np.random.Generator(np.random.PCG64(77))
    for _ in range(4):
        n_docs = int(rng.integers(300, 900))
        vocab = int(rng.integers(50, 200))
        pairs = _fuzz_pairs(rng, n_docs, vocab, 2, 12, 4, 0.05)
        s = SparseSearcher(
            SparseIndex.build([SparseVector(i, v) for i, v in pairs]),
            device="cpu")
        for _ in range(6):
            nnz = int(rng.integers(1, 8))
            q = SparseVector(rng.choice(vocab, nnz, replace=False),
                             (rng.random(nnz) * 2 + 0.1).astype(np.float32))
            k = int(rng.integers(1, 20))
            _same(s.search_rerank(q, k=k, R=16), s.search_exact(q, k=k),
                  ("rerank", k))


def test_rerank_improves_on_quantized():
    """There are queries whose quantized top-k differs from the exact one;
    rerank fixes them."""
    rng = np.random.Generator(np.random.PCG64(5))
    pairs = _fuzz_pairs(rng, 600, 80, 3, 10, 6, 0.01)
    s = SparseSearcher(
        SparseIndex.build([SparseVector(i, v) for i, v in pairs]),
        device="cpu")
    diffs = 0
    for _ in range(20):
        nnz = int(rng.integers(2, 6))
        q = SparseVector(rng.choice(80, nnz, replace=False),
                         (rng.random(nnz) + 0.1).astype(np.float32))
        _, qd, _ = s.search(q, k=10)
        want = s.search_exact(q, k=10)
        _same(s.search_rerank(q, k=10), want, "rerank")
        if list(qd) != list(want[1]):
            diffs += 1
    assert diffs >= 1, "fuzz never exercised the quantized/exact gap"


def test_batch_pruned_parity_vs_oracle():
    """The serving path: a batch forced onto the pruned route stays
    bit-exact against the quantized numpy oracle and the JAX searcher
    under the same forcing, escalation included. The zero heavy bank alone
    opens the route."""
    rng = np.random.Generator(np.random.PCG64(21))
    pairs = _random_pairs(rng, 1500, vocab=300, nnz=25)
    port, jax_idx = _both(pairs)
    searcher = SparseSearcher(port, device="cpu")
    jax_s = JaxSearcher(jax_idx)
    for ex in (searcher.executor, jax_s.executor):
        ex.prune_min_docs = 1024
        ex.prune_solo_min_docs = 1024
        ex.approx_min_q = 4
        ex.prune_B0 = 2  # tiny tile budget -> escalation too
    qp = _random_pairs(np.random.Generator(np.random.PCG64(22)), 12,
                       vocab=300, nnz=12)
    qs = [SparseVector(i, v) for i, v in qp]
    ex = searcher.executor
    before = {n: c.value() for n, c in ex.metrics.items()}
    batch = searcher.search_batch(qs, 10)
    assert ex.metrics["pruned"].value() > before["pruned"], "not pruned"
    assert ex.metrics["escalations"].value() > before["escalations"]
    want = jax_s.search_batch([JaxVector(i, v) for i, v in qp], 10)
    for q, b, w in zip(qs, batch, want):
        _same(b, searcher.search_oracle(q, 10), "vs oracle")
        _same(b, w, "vs jax")


def test_rerank_batch_matches_exact():
    """search_rerank_batch (one quantized batch + host exact rescore +
    certificate, escalating per query) equals brute-force exact search
    bit for bit, as the JAX searcher's does."""
    rng = np.random.Generator(np.random.PCG64(123))
    pairs = _fuzz_pairs(rng, 700, 150, 2, 12, 4, 0.05)
    port, jax_idx = _both(pairs)
    s = SparseSearcher(port, device="cpu")
    qp = []
    for _ in range(12):
        nnz = int(rng.integers(1, 8))
        qp.append((rng.choice(150, nnz, replace=False),
                   (rng.random(nnz) * 2 + 0.1).astype(np.float32)))
    qs = [SparseVector(i, v) for i, v in qp]
    got = s.search_rerank_batch(qs, k=10, R=16)
    want = JaxSearcher(jax_idx).search_rerank_batch(
        [JaxVector(i, v) for i, v in qp], k=10, R=16)
    for q, g, w in zip(qs, got, want):
        _same(g, s.search_exact(q, k=10), "vs exact")
        _same(g, w, "vs jax")


def test_searcher_over_converted_index():
    """sparse_index_from_jax carries a JAX index across: the port searches
    the JAX package's own index with the same answers."""
    rng = np.random.Generator(np.random.PCG64(31))
    pairs = _random_pairs(rng, 400, vocab=200)
    jax_idx = JaxIndex.build([JaxVector(i, v) for i, v in pairs])
    port = sparse_index_from_jax(jax_idx)
    assert port.scales == jax_idx.scales and port.num_docs == 400
    searcher = SparseSearcher(port, device="cpu")
    jax_s = JaxSearcher(jax_idx)
    for ids, vals in _random_pairs(np.random.Generator(np.random.PCG64(32)),
                                   3, vocab=200, nnz=10):
        jq = JaxVector(ids, vals)
        q = sparse_vector_from_jax(jq)
        _same(searcher.search(q, 10), jax_s.search(jq, 10), "search")
        _same(searcher.search_exact(q, 10), jax_s.search_exact(jq, 10),
              "exact")


def test_searcher_places_everything_on_its_device():
    pairs = _random_pairs(np.random.Generator(np.random.PCG64(6)), 40)
    s = SparseSearcher(SparseIndex.build([SparseVector(i, v) for i, v in pairs]),
                       device="cpu")
    assert s.executor.index.heavy_bank.device.type == "cpu"
    assert s.executor.index.live.device.type == "cpu"


SPLADE_TABLE = (Path(__file__).resolve().parents[1] / "gpubench" / "traffic"
                / "splade-dev-b256.json")


def _table_queries(n):
    """The first ``n`` queries of the SPLADE cell's committed table, read as
    its adapter reads them (``np.float32(float(text))``)."""
    out = []
    for e in json.loads(SPLADE_TABLE.read_text())["table"][:n]:
        ids, ws = zip(*(c.split("^") for c in e["should"]))
        out.append(SparseVector([int(t) for t in ids],
                                [np.float32(float(w)) for w in ws]))
    return out


def _splade_shaped_index(n_docs=500, nnz=100, extra=(), flat=False):
    """A small index over BERT's 30,522 WordPiece ids from
    ``SparseIndex.from_csr``; ``extra`` ids go into the first document;
    ``flat`` weights are all 1, so every term has the same scale."""
    rng = np.random.Generator(np.random.PCG64(41))
    rows = [np.sort(rng.choice(30522, nnz, replace=False))
            for _ in range(n_docs)]
    rows[0] = np.unique(np.concatenate([rows[0], np.asarray(extra, int)]))
    indptr = np.zeros(n_docs + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=indptr[1:])
    ids = np.concatenate(rows)
    vals = (np.ones(len(ids), np.float32) if flat
            else (rng.random(len(ids)) * 3 + 0.01).astype(np.float32))
    return SparseIndex.from_csr(indptr, ids, vals)


def _oracle_plan(s, query, pad_to=0, alpha=1.0):
    """The per-clause construction: a ``TermPlan`` a present id (its key's
    bisection, ``f32(f32(w) * f32(scale))``), QBlock selection, padding
    clauses, then ``RowExecutor.build_plan``."""
    cands = []
    for t, w in zip(query.ids, query.values):
        key = str(int(t))
        tid = s.pp.term_id(key)
        if tid < 0:
            continue
        weight = np.float32(
            np.float32(w) * np.float32(s.index.scales[key]))
        cands.append((float(weight) * 255, tid, float(weight)))
    if alpha < 1.0 and cands:
        cands.sort(key=lambda c: -c[0])
        total = sum(c[0] for c in cands)
        acc, cut = 0.0, len(cands)
        for i, c in enumerate(cands):
            acc += c[0]
            if acc >= alpha * total:
                cut = i + 1
                break
        cands = cands[:cut]
    tps = [TermPlan(tid, w, should=True) for _, tid, w in cands]
    tps += [TermPlan(-1, 0.0, should=True)] * (pad_to - len(tps))
    if not tps:
        return None
    return s.executor.build_plan(
        tps, min_should=1, idf_of_tid=lambda tid: np.float32(np.nan))


def _oracle_batch(s, queries):
    pad_to = _bucket_tq(max(max(len(q), 1) for q in queries))
    return [_oracle_plan(s, q, pad_to) for q in queries]


def _assert_same_plan(got, want, what):
    if want is None:
        assert got is None, what
        return
    for name in ("hidx", "lidx", "scoring", "req", "sho", "neg"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
    assert (got.num_required, got.min_should, got.pure_or) == (
        want.num_required, want.min_should, want.pure_or), what
    assert len(got.light_entries) == len(want.light_entries), what
    for (gt, gw), (wt, ww) in zip(got.light_entries, want.light_entries):
        assert type(gt) is int and type(gw) is np.float32, what
        assert gt == wt, what
        assert gw.view(np.uint32) == np.float32(ww).view(np.uint32), what


def _q(ids, vals=None):
    return SparseVector(ids, np.ones(len(ids), np.float32)
                        if vals is None else vals)


def _plan_case(name):
    """(index, queries, how): ``how`` is "batch" (``_plan_batch`` against
    the padded oracle) or ("solo", alpha) (``_plan`` a query, or
    ``_plan_batch`` unpadded, against the unpadded oracle)."""
    if name == "outside_table":
        # keys a dense id table cannot hold: negative, and 2**24 and over
        idx = _splade_shaped_index(50, 20, extra=(-7, -1, 1 << 24, 1 << 30))
        qs = [_q([-7, -3, -1, 5, 1 << 24, (1 << 24) + 1, 1 << 30]),
              _q([-2, (1 << 31) - 1])]
        return idx, qs, "batch"
    idx = _splade_shaped_index()
    table = _table_queries(256)
    present = idx.segment.fields["_sparse"].postings.terms
    hits = sorted(int(t) for t in present)
    if name == "splade_table":
        return idx, table, "batch"
    if name == "absent_ids":
        absent = sorted(set(range(30522)) - set(hits))[:3]
        qs = [_q(list(q.ids) + absent + [-5, 30522, 999999],
                 np.concatenate([q.values, np.full(6, 0.75, np.float32)]))
              for q in table[:6]]
        return idx, qs, "batch"
    if name == "all_absent":
        absent = sorted(set(range(30522)) - set(hits))[:4]
        return idx, [table[0], _q(absent + [-1, 40000]), table[1]], "batch"
    if name == "fills_bucket":
        # the longest query's 8 ids are all present: its plan fills the
        # bucket of 8 and is pure OR; the others are padded to it
        qs = [_q(hits[:8], np.linspace(0.5, 2, 8).astype(np.float32)),
              _q(hits[8:13]), _q(hits[13:14] + [30522])]
        return idx, qs, "batch"
    if name == "zero_weight":
        return idx, [_q(hits[:5], np.asarray([1, 0, 2, 0, 3], np.float32)),
                     _q(hits[5:7], np.zeros(2, np.float32))], "batch"
    if name == "solo":
        return idx, table[:1], ("solo", 1.0)
    # "alpha_0.5", "alpha_1.0": equal scales, so clauses of equal query
    # weight tie on their bound and keep their id order
    alpha = float(name.split("_")[1])
    idx = _splade_shaped_index(flat=True)
    ties = _q(hits[:40], np.resize(np.float32([1, 2, 1, 3]), 40))
    return idx, table[:64] + [ties, _q([30522])], ("solo", alpha)


@pytest.mark.parametrize("case", [
    "splade_table", "absent_ids", "all_absent", "fills_bucket",
    "zero_weight", "outside_table", "solo", "alpha_0.5", "alpha_1.0"])
def test_plan_batch_matches_per_clause_oracle(case):
    """The vectorised plans equal the per-clause construction's field for
    field and entry for entry (light weights to the f32 bit)."""
    idx, qs, how = _plan_case(case)
    s = SparseSearcher(idx, device="cpu")
    if how == "batch":
        got, want = s._plan_batch(qs), _oracle_batch(s, qs)
        assert len({len(p.hidx) for p in got}) == 1
    elif len(qs) == 1:
        got = [s._plan(qs[0], alpha=how[1])]
        want = [_oracle_plan(s, qs[0], alpha=how[1])]
    else:
        got = s._plan_batch(qs, pad=False, alpha=how[1])
        want = [_oracle_plan(s, q, alpha=how[1]) for q in qs]
    assert len(got) == len(want) == len(qs)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same_plan(g, w, (case, i))
    if case == "fills_bucket":
        assert [p.pure_or for p in got] == [True, False, False]
    if case == "solo":
        assert got[0].pure_or and len(got[0].hidx) == _bucket_tq(
            len(got[0].light_entries))
    if case == "alpha_0.5":
        assert sum(len(p.light_entries) for p in got if p) < sum(
            len(p.light_entries) for p in s._plan_batch(qs, pad=False) if p)


def test_sparse_plans_batched_counter():
    """``search.sparse_plans_batched`` counts the queries the vectorised
    pass planned: a batch's size a ``dispatch_batch``, 1 a ``search``."""
    pairs = _random_pairs(np.random.Generator(np.random.PCG64(42)), 200)
    s = SparseSearcher(
        SparseIndex.build([SparseVector(i, v) for i, v in pairs]),
        device="cpu")
    qs = [SparseVector(i, v) for i, v in _random_pairs(
        np.random.Generator(np.random.PCG64(43)), 5, nnz=15)]
    counter = registry.counter("search.sparse_plans_batched")
    before = counter.value()
    s.collect_batch(s.dispatch_batch(qs, 10))
    assert counter.value() - before == len(qs)
    before = counter.value()
    s.search(qs[0], 10)
    assert counter.value() - before == 1
