"""The port's block-at-a-time engine (``diagon_tpu_torch.search.engine``,
X2's plain version on the CPU) against the JAX package's
(``diagon_tpu.search.engine`` on the JAX CPU backend) and the port's
oracle, on three segments (``test_device_engine``'s 700-doc corpus, one
with deletes, one past the 1024-doc pad).

Tolerance 0 throughout: the same plan arrays, the same fused rows (f32
bits, docids as f32, hits), the same executor results, and the oracle's
docids, score bits and hits. The families: term, missing term, OR, AND,
mixed, min_should, a term given twice, FILTER-only, MUST_NOT, boosts."""

import numpy as np
import pytest
import torch

from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search import engine as jengine
from diagon_tpu.search.device_index import load_segment as jax_load
from diagon_tpu.search.query import BooleanClause, BooleanQuery, Occur
from diagon_tpu.search.query import TermQuery
from diagon_tpu.search.searcher import IndexSearcher as JaxSearcher
from diagon_tpu_torch.ops import launches
from diagon_tpu_torch.ops import block_score as x2
from diagon_tpu_torch.search import IndexSearcher, engine
from diagon_tpu_torch.search.convert import query_from_jax, segment_from_jax
from diagon_tpu_torch.search.device_index import load_segment
from diagon_tpu_torch.search.oracle import OracleSearcher
from diagon_tpu_torch.search.query import Occur as POccur
from diagon_tpu_torch.search.topdocs import ScoreDoc, TopDocs, merge_top_docs

K = 10
VOCAB = np.asarray([f"w{i}" for i in range(200)]
                   + ["oil", "price", "trade", "market"], dtype=object)


def _segment(rng, n, name, delete_every=0):
    mem = MemoryIndex()
    for _ in range(n):
        ln = max(1, int(rng.normal(40, 40 / 3)))
        mem.add_document(Document().add(
            TextField("body", " ".join(rng.choice(VOCAB, size=ln)))))
    seg = flush_memory_index(mem, name)
    for d in range(5, n if delete_every else 0, delete_every or 1):
        seg.delete_document(d)
    return seg


@pytest.fixture(scope="module")
def engines():
    """(JAX searcher, port searcher, port oracle, JAX executors, port
    executors) over the same three segments."""
    rng = np.random.Generator(np.random.PCG64(42))
    segs = [_segment(rng, 700, "_0"), _segment(rng, 900, "_1", 7),
            _segment(rng, 1100, "_2")]
    js = JaxSearcher(segs)
    ps = IndexSearcher([segment_from_jax(s) for s in segs], device="cpu")
    lut = ps._ctx("body").tf_lut_host
    np.testing.assert_array_equal(lut, js._ctx("body").tf_lut_host)
    pex = [engine.SegmentExecutor(ds, "body", lut) for ds in ps.device_segments]
    return (js, ps, OracleSearcher(ps._host_segments()),
            js._ctx("body").executors, pex)


def T(w, boost=1.0):
    return TermQuery("body", w, boost=boost)


def B(*clauses, min_should=0):
    return BooleanQuery([BooleanClause(q, o) for q, o in clauses], min_should)


M, S, F, N = Occur.MUST, Occur.SHOULD, Occur.FILTER, Occur.MUST_NOT

QUERIES = {
    "term": T("oil"),
    "term_rare": T("w100"),
    "term_boost": T("price", boost=2.5),
    "missing": T("zzz_not_there"),
    "or2": B((T("oil"), S), (T("price"), S)),
    "or5": B(*[(T(w), S) for w in ["oil", "trade", "market", "price", "w3"]]),
    "or20": B(*[(T(f"w{i * 7}"), S) for i in range(19)] + [(T("oil"), S)]),
    "and2": B((T("oil"), M), (T("price"), M)),
    "and3": B((T("w1"), M), (T("w2"), M), (T("w3"), M)),
    "and_missing": B((T("oil"), M), (T("zzz_missing"), M)),
    "mixed": B((T("oil"), M), (T("price"), S), (T("w5"), S), (T("w9"), N)),
    "min_should2": B(*[(T(w), S) for w in ["w1", "w2", "w3", "oil"]],
                     min_should=2),
    "twice_should": B((T("oil"), S), (T("oil"), S), (T("price"), S)),
    "twice_must": B((T("w1"), M), (T("w1"), M), (T("trade"), S)),
    "filter_only": B((T("oil"), F), (T("price"), F)),
    "filter_should": B((T("oil"), F), (T("market"), S), (T("w4"), S)),
    "must_not": B((T("oil"), S), (T("trade"), S), (T("price"), N)),
    "adjacent_terms": B((T("w10"), S), (T("w100"), S), (T("w101"), S)),
}


def _plans(searcher, query):
    """The port's block plans per segment for ``query``, built as the JAX
    searcher builds its own: the clauses in plan order (MUST, FILTER,
    SHOULD, MUST_NOT, each by term text), each posting term's blocks, MUST
    and SHOULD weighted by idf * boost."""
    field, clauses, min_should = searcher._term_clauses(query)
    ctx = searcher._ctx(field)

    def group(o):
        return sorted([q for q, c in clauses if c == o],
                      key=lambda q: q.term.text)

    def idf(q):
        return float(searcher._idf(field, q.term.text, q.boost))

    plans = []
    for ds in searcher.device_segments:
        f = ds.fields[field]
        tps = ([engine.TermPlan(f.term_id(q.term.text), idf(q), required=True)
                for q in group(POccur.MUST)]
               + [engine.TermPlan(f.term_id(q.term.text), 0.0, required=True)
                  for q in group(POccur.FILTER)]
               + [engine.TermPlan(f.term_id(q.term.text), idf(q), should=True)
                  for q in group(POccur.SHOULD)]
               + [engine.TermPlan(f.term_id(q.term.text), 0.0, negated=True)
                  for q in group(POccur.MUST_NOT)])
        plans.append(engine.build_segment_plan(f, tps, min_should,
                                               float(1.0 / ctx.avgdl)))
    return plans


@pytest.fixture(scope="module")
def plans(engines):
    js, ps = engines[:2]
    out = {}
    for name, q in QUERIES.items():
        field, clauses, ms = js._term_clauses(q)
        out[name] = (js._segment_plans(field, clauses, ms),
                     _plans(ps, query_from_jax(q)))
    return out


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _topdocs(ps, si, res):
    scores, docs, hits = res
    base = ps.doc_bases[si]
    sds = [ScoreDoc(int(d) + base, float(s))
           for s, d in zip(scores, docs) if s >= 0.0][: int(hits)]
    return TopDocs(int(hits), sds)


def _same_topdocs(a, b):
    assert a.total_hits == b.total_hits
    assert [sd.doc for sd in a.score_docs] == [sd.doc for sd in b.score_docs]
    np.testing.assert_array_equal(_bits([sd.score for sd in a.score_docs]),
                                  _bits([sd.score for sd in b.score_docs]))


@pytest.mark.parametrize("name", list(QUERIES))
def test_plans_equal_the_jax_plans(engines, plans, name):
    for si, (jp, pp) in enumerate(zip(*plans[name])):
        for col in ("blocks", "weight", "req", "sho", "neg"):
            got, want = getattr(pp, col), getattr(jp, col)
            assert got.dtype == want.dtype, col
            np.testing.assert_array_equal(got, want, err_msg=col)
        assert (pp.num_required, pp.min_should, pp.inv_avgdl) == (
            jp.num_required, jp.min_should, jp.inv_avgdl)
        # the port's run ends: the runs tile the valid entries, each run
        # every block of one term, in order
        term = engines[4][si].field.block_term.numpy()
        start = engines[4][si].field.block_start
        assert pp.run_end.dtype == np.int32 and len(pp.run_end) == pp.b_pad
        runs = x2.plan_runs(pp.run_end)
        assert sum(p1 - p0 for p0, p1 in runs) == int((pp.blocks >= 0).sum())
        for p0, p1 in runs:
            t = term[pp.blocks[p0]]
            np.testing.assert_array_equal(
                pp.blocks[p0:p1], np.arange(start[t], start[t + 1]))


@pytest.mark.parametrize("name", list(QUERIES))
def test_fused_rows_equal_the_jax_functions(engines, plans, name):
    jex, pex = engines[3:]
    for si, (jp, pp) in enumerate(zip(*plans[name])):
        jargs = (*jex[si]._index_args(), *jex[si]._plan_args(jp))
        pargs = (*pex[si]._index_args(), *pex[si]._plan_args(pp))
        kw = dict(window_words=pex[si].field.window_words,
                  run_end=pex[si]._device_plan(pp)[6])
        want = np.asarray(jengine.score_and_topk(
            *jargs, window_words=jex[si].field.window_words, k=K))
        got = engine.score_and_topk(*pargs, k=K, **kw)
        assert got.dtype == torch.float32 and got.shape == (2 * K + 1,)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        want_n = int(jengine.count_matches(
            *jargs, window_words=jex[si].field.window_words))
        got_n = engine.count_matches(*pargs, **kw)
        assert got_n.dtype == torch.int32 and int(got_n) == want_n
        s, d, h = engine.unfuse_topk_device(got, K)
        assert d.dtype == torch.int32 and int(h) == want_n


@pytest.mark.parametrize("name", list(QUERIES))
def test_executor_equals_jax_and_oracle(engines, plans, name):
    js, ps, oracle, jex, pex = engines
    q = query_from_jax(QUERIES[name])
    parts, total = [], 0
    for si, (jp, pp) in enumerate(zip(*plans[name])):
        got = pex[si].top_k(pp, K)
        want = jex[si].top_k(jp, K)
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
        np.testing.assert_array_equal(got[1], want[1])
        assert int(got[2]) == int(want[2])
        n = pex[si].count(pp)
        assert n == jex[si].count(jp) == int(got[2])
        parts.append(_topdocs(ps, si, got))
        total += n
    merged = merge_top_docs(parts, K)
    _same_topdocs(merged, oracle.search(q, K))
    assert total == oracle.count(q)
    # the row engine (the searcher's route) gives the same answer
    _same_topdocs(merged, ps.search(q, K))


def test_batch_equals_jax_and_solo(engines, plans):
    jex, pex = engines[3:]
    names = list(QUERIES)
    for si in range(len(pex)):
        jps = [plans[n][0][si] for n in names]
        pps = [plans[n][1][si] for n in names]
        got = pex[si].top_k_batch(pps, K)
        want = jex[si].top_k_batch(jps, K)
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        again = pex[si].top_k_batch(pps, K)  # from the batch cache
        assert len(pex[si]._batch_cache) >= 1
        for a, b in zip(again, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for i, pp in enumerate(pps):
            solo = pex[si].top_k(pp, K)
            np.testing.assert_array_equal(_bits(solo[0]), _bits(got[0][i]))
            np.testing.assert_array_equal(solo[1], got[1][i])


def test_score_and_topk_batch_fused_rows(engines, plans):
    """The raw [Q, 2k+1] rows of score_and_topk_batch, bit-equal, with k 3
    and plans of unequal lengths padded to one bucket."""
    jex, pex = engines[3:]
    names = ["or20", "mixed", "twice_should", "filter_only", "missing"]
    pps = [plans[n][1][2] for n in names]
    args = pex[2].batch_args(pps)
    want = np.asarray(jengine.score_and_topk_batch(
        *jex[2]._index_args(), *(a.numpy() for a in args[:6]),
        window_words=jex[2].field.window_words, k=3))
    got = engine.score_and_topk_batch(
        *pex[2]._index_args(), *args[:6], run_end=args[6],
        window_words=pex[2].field.window_words, k=3)
    assert got.shape == (len(names), 7)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_pure_must_not_plan_matches_nothing(engines):
    js, ps, oracle, jex, pex = engines
    f = pex[0].field
    tps = [engine.TermPlan(f.term_id("oil"), 0.0, negated=True)]
    plan = engine.build_segment_plan(f, tps, 0, 0.1)
    assert pex[0].count(plan) == 0
    assert int(pex[0].top_k(plan, K)[2]) == 0
    q = query_from_jax(B((T("oil"), N)))
    assert oracle.count(q) == 0


def test_block_runs_split_duplicates_and_adjacent_terms(engines, plans):
    """A term given twice makes two runs; two terms whose block ranges
    touch make two runs, though their block ids run on."""
    f = engines[4][0].field
    term = f.block_term.numpy()
    for name in ("twice_should", "adjacent_terms"):
        pp = plans[name][1][0]
        runs = x2.plan_runs(pp.run_end)
        valid = pp.blocks[pp.blocks >= 0]
        assert sum(p1 - p0 for p0, p1 in runs) == len(valid)
        for p0, p1 in runs:
            assert len(set(term[pp.blocks[p0:p1]])) == 1
        assert len(runs) == 3


def test_source_less_segments(engines):
    """load_segment(keep_source=False) keeps no host copy; SegmentExecutor
    still serves it, and IndexSearcher over it raises on the first search
    as the JAX searcher does."""
    js, ps, oracle, jex, pex = engines
    jseg = js._host_segments()[0]
    ds = load_segment(ps._host_segments()[0], "cpu", keep_source=False)
    assert ds.source is None
    assert load_segment(ps._host_segments()[0], "cpu").source is not None
    ex = engine.SegmentExecutor(ds, "body", ps._ctx("body").tf_lut_host)
    pp = _plans(ps, query_from_jax(QUERIES["mixed"]))[0]
    got, want = ex.top_k(pp, K), pex[0].top_k(pp, K)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(got[1], want[1])
    q = QUERIES["or5"]
    with pytest.raises(RuntimeError) as jerr:
        JaxSearcher([jax_load(jseg, keep_source=False)]).search(q, K)
    with pytest.raises(RuntimeError) as perr:
        IndexSearcher([ds], device="cpu").search(query_from_jax(q), K)
    assert str(perr.value) == str(jerr.value)
    assert "keep_source=True" in str(perr.value)


def test_batch_chunks_give_the_same_rows(engines, plans, monkeypatch):
    """Queries split into chunks of 2 (as the free device memory would
    split them) give the rows of one call."""
    pex = engines[4]
    pps = [plans[n][1][1] for n in QUERIES]
    whole = pex[1].top_k_batch(pps, K)
    monkeypatch.setattr(engine, "query_chunk", lambda D, Q, k, dev: 2)
    pex[1]._batch_cache.clear()
    split = pex[1].top_k_batch(pps, K)
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_x2_checks_its_arguments(engines, plans):
    ex = engines[4][0]
    pp = plans["or2"][1][0]
    blocks, weight, req, sho, neg, bp, run_end = ex._device_plan(pp)
    f = ex.field
    args = [f.packed, f.block_base, f.block_count, f.block_doc_bits,
            f.block_freq_bits, f.block_word_off, f.norms, ex.tf_lut,
            ex.live_mask, blocks[None], run_end[None], weight[None],
            req[None], sho[None], neg[None], bp[None], f.window_words]
    cand_s, cand_d, hits = x2.block_score(*args, k=K)
    D = ex.segment.num_docs_pad
    tile = x2.tile_for(D, 1, x2.H100_SMS)
    assert cand_s.shape == cand_d.shape == (1, x2.candidates(D, tile, K))
    assert x2.block_score(*args, scores=False)[:2] == (None, None)
    with pytest.raises(ValueError):
        x2.block_score(*args)  # the score form needs k
    with pytest.raises(ValueError):
        x2.block_score(*args, k=K, tile=4096)
    bad = list(args)
    bad[4] = f.block_freq_bits[:-1]  # one block short
    with pytest.raises(ValueError):
        x2.block_score(*bad)
    bad = list(args)
    bad[11] = weight[None].double()
    with pytest.raises(TypeError):
        x2.block_score(*bad)
    bad = list(args)
    bad[15] = bp
    with pytest.raises(ValueError):
        x2.block_score(*bad)
    bad = list(args)
    bad[10] = run_end[None, :-1]  # one run end short
    with pytest.raises(ValueError):
        x2.block_score(*bad)
    assert launches("block_score") == 0  # the CPU path never counts


def test_tile_for_fills_the_card():
    assert x2.tile_for(19456, 1, 132) == 256
    assert x2.tile_for(1003520, 1, 132) == 2048
    assert x2.tile_for(19456, 1024, 132) == 2048


@pytest.mark.cuda
def test_x2_on_the_card_equals_plain(engines, plans):
    """X2 on the card against its plain version on the same tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (chip_smoke.py checks X2)")
    ps = engines[1]
    ds = load_segment(ps._host_segments()[2], "cuda")
    ex = engine.SegmentExecutor(ds, "body", ps._ctx("body").tf_lut_host)
    for name in QUERIES:
        pp = plans[name][1][2]
        f = ex.field
        blocks, *cols, run_end = (a[None] for a in ex._device_plan(pp))
        args = (f.packed, f.block_base, f.block_count, f.block_doc_bits,
                f.block_freq_bits, f.block_word_off, f.norms, ex.tf_lut,
                ex.live_mask, blocks, run_end, *cols, f.window_words)
        for k in (K, x2.MAX_TILE):
            got = x2.block_score(*args, k=k)
            tile = x2.tile_for(f.norms.shape[0], 1, torch.cuda
                               .get_device_properties(0).multi_processor_count)
            want = x2.block_score_reference(*args, k=k, tile=tile)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].cuda().view(torch.int32))
            assert torch.equal(got[1], want[1].cuda())
            assert torch.equal(got[2], want[2].cuda())


# X2's candidate form: each tile's first min(k, n) docs in lax.top_k's
# order; exact_topk over them gives the JAX fused rows. (tile, k) cases:
# k below, at and above the tile, a tile that does not divide D (384)
CANDIDATE_CASES = [(256, K), (512, K), (384, K), (256, 256), (256, 300),
                   (512, 512), (512, 2048)]


@pytest.fixture(scope="module")
def big(engines):
    """A 3,000-doc segment with deletes (D 4,096 padded): the JAX and the
    port's executors over it, with the JAX searcher's tf table."""
    rng = np.random.Generator(np.random.PCG64(7))
    seg = _segment(rng, 3000, "_3", 11)
    jctx = JaxSearcher([seg])._ctx("body")
    jex, lut = jctx.executors[0], jctx.tf_lut_host
    ds = load_segment(segment_from_jax(seg), "cpu")
    return jex, engine.SegmentExecutor(ds, "body", lut), ds


def _batch_plans(ps, ds):
    """QUERIES' port plans on ``ds`` (unequal B), in QUERIES' order."""
    s = IndexSearcher([ds], device="cpu")
    s._ctx("body")
    return [_plans(s, query_from_jax(q))[0] for q in QUERIES.values()]


def _x2_args(ex, args):
    f = ex.field
    blocks, weight, req, sho, neg, bp, run_end = args
    return (f.packed, f.block_base, f.block_count, f.block_doc_bits,
            f.block_freq_bits, f.block_word_off, f.norms, ex.tf_lut,
            ex.live_mask, blocks, run_end, weight, req, sho, neg, bp,
            f.window_words)


@pytest.mark.parametrize("tile,k", CANDIDATE_CASES)
def test_candidate_form_fused_rows_equal_jax(engines, plans, big, tile, k):
    """exact_topk over the plain candidate form, at a pinned tile, gives
    the JAX score_and_topk_batch rows bit for bit, for the whole QUERIES
    batch (unequal B: a term twice, FILTER-only, MUST_NOT, a missing term,
    ties in score, k above the match count) on D 2,048 and 4,096."""
    jbig, pbig, _ = big
    cases = [(engines[3][2], engines[4][2], [plans[n][1][2] for n in QUERIES]),
             (jbig, pbig, None)]
    for jex, pex, pps in cases:
        if pps is None:
            pps = [engine.build_segment_plan(
                pex.field, [engine.TermPlan(pex.field.term_id(w), 1.5,
                                            should=True)
                            for w in ("oil", "price", "w3", "w3")], 1, 0.02)]
            pps += _batch_plans(engines[1], pex.segment)
        D = pex.segment.num_docs_pad
        kq = min(k, D)
        args = pex.batch_args(pps)
        want = np.asarray(jengine.score_and_topk_batch(
            *jex._index_args(), *(a.numpy() for a in args[:6]),
            window_words=jex.field.window_words, k=kq))
        cs, cd, hits = x2.block_score_reference(*_x2_args(pex, args),
                                                k=kq, tile=tile)
        assert cs.shape == cd.shape == (len(pps), x2.candidates(D, tile, kq))
        got = engine._fuse(cs, cd, hits, kq)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        # the wrapper on the CPU at the same pinned tile
        again = x2.block_score(*_x2_args(pex, args), k=kq, tile=tile)
        for a, b in zip(again, (cs, cd, hits)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("tile,k", CANDIDATE_CASES[:3])
def test_candidate_form_solo_equals_jax(engines, plans, big, tile, k):
    """One plan at a time against the JAX score_and_topk, and each tile's
    list in (score desc, docid asc) order inside the tile."""
    jbig, pbig, _ = big
    for name in ("or20", "filter_only", "twice_must", "must_not", "missing",
                 "term_rare"):
        jp = plans[name][0][2]
        pp = plans[name][1][2]
        jex, pex = engines[3][2], engines[4][2]
        want = np.asarray(jengine.score_and_topk(
            *jex._index_args(), *jex._plan_args(jp),
            window_words=jex.field.window_words, k=k))
        args = tuple(a[None] for a in pex._device_plan(pp))
        cs, cd, hits = x2.block_score_reference(*_x2_args(pex, args), k=k,
                                                tile=tile)
        got = engine._fuse(cs, cd, hits, k)[0]
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        D = pex.segment.num_docs_pad
        kk = min(k, tile)
        for t0 in range(0, D, tile):
            at = (t0 // tile) * kk
            s = cs[0, at:at + kk].numpy()
            d = cd[0, at:at + kk].numpy()
            assert ((d >= t0) & (d < t0 + tile)).all()
            assert (np.diff(s) <= 0).all()
            tie = np.diff(s) == 0
            assert (np.diff(d)[tie] > 0).all()


def test_runs_are_consecutive_word_ranges(engines, plans, big):
    """X2 stages a run's blocks that reach a tile as one word range: on
    the port's segments (converted, flushed with deletes, and from the
    bulk builder) every block's words start where the previous block's
    end, ascending, and fit the decode window; so every plan run's blocks
    hold consecutive ascending word ranges."""
    from diagon_tpu_torch.bench.bulk_build import build_synthetic_segment

    fields = [ex.field for ex in engines[4]] + [big[1].field]
    fields.append(load_segment(build_synthetic_segment(3000), "cpu")
                  .fields["body"])
    for f in fields:
        nb = f.num_blocks
        cnt = f.block_count[:nb].long()
        words = ((cnt * f.block_doc_bits[:nb] + 31) // 32
                 + (cnt * f.block_freq_bits[:nb] + 31) // 32)
        off = f.block_word_off[:nb].long()
        assert int(off[0]) == 0
        assert torch.equal(off[1:], off[:-1] + words[:-1])
        assert int(words.max()) <= f.window_words
        assert int(off[-1] + words[-1]) <= f.packed.shape[0]
    for name in QUERIES:
        for si, pp in enumerate(plans[name][1]):
            f = engines[4][si].field
            off = f.block_word_off.numpy()
            for p0, p1 in x2.plan_runs(pp.run_end):
                b = pp.blocks[p0:p1]
                assert (np.diff(b) == 1).all()
                assert (np.diff(off[b]) > 0).all()
