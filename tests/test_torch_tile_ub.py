"""The port's small-batch tile-UB route against the JAX package.

``build_tile_aux`` and ``_pack_live_bits`` must give the JAX words bit for
bit; ``row_score_topk_pruned_or`` the JAX function's fused [Q, 2k+2] rows
bit for bit (score bits, docids, hits, the safe flag) on seeded banks; and
a searcher forced onto the route (``approx_min_q`` = 1000, the cases of
``tests/unit/test_pruned_engine.py`` that run it) the JAX searcher's and
the oracle's answers: docids, score bits and hits. Inputs are made from
seeds with numpy; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search import row_engine as jre
from diagon_tpu.search.oracle import OracleSearcher
from diagon_tpu.search.query import BooleanQuery, Occur, TermQuery
from diagon_tpu.search.searcher import IndexSearcher as JaxSearcher
from diagon_tpu_torch.search import IndexSearcher
from diagon_tpu_torch.search import row_engine as tre
from diagon_tpu_torch.search.convert import query_from_jax, segment_from_jax

K = 10
D = 2048  # 16 tiles


def _bank(rng, n, tied_rows=0, zero_first=False):
    """f32 [n, D]: about a third of the docs nonzero, values from a short
    list (equal scores across docs); the first ``tied_rows`` rows hold one
    value on every 8th doc, so every tile has the same maximum."""
    vals = np.asarray([0.25, 0.5, 1.0, 1.5, 2.75], np.float32)
    bank = np.where(rng.random((n, D)) < 0.33,
                    vals[rng.integers(0, len(vals), (n, D))], 0).astype(
                        np.float32)
    for r in range(tied_rows):
        bank[r] = 0
        bank[r, r % 8 :: 8] = vals[r % len(vals)]
    if zero_first:
        bank[0] = 0
    return bank


def _live(rng, deleted):
    live = np.ones(D, np.float32)
    live[D - 77 :] = 0  # padded docs past the segment's end
    if deleted:
        live[rng.random(D) < 0.2] = 0
    return live


def _plans(rng, Q, Tq, H, L):
    """hidx/lidx i32 [Q, Tq]: about half the clauses heavy rows, the rest
    light rows or padding (lidx 0, the zero row)."""
    hidx = np.where(rng.random((Q, Tq)) < 0.5, rng.integers(0, H, (Q, Tq)),
                    -1).astype(np.int32)
    lidx = np.where(hidx < 0, rng.integers(0, L, (Q, Tq)), 0).astype(np.int32)
    return hidx, lidx


def _u32(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [1, 5, 40])
def test_tile_aux_and_live_bits_equal_jax(seed, n):
    rng = np.random.default_rng(seed)
    bank = _bank(rng, n, tied_rows=min(n, 2))
    ub, bits = tre.build_tile_aux(torch.from_numpy(bank))
    jub, jbits = jre.build_tile_aux(jnp.asarray(bank))
    assert ub.dtype == torch.float32 and bits.dtype == torch.int32
    np.testing.assert_array_equal(_u32(ub.numpy()), _u32(np.asarray(jub)))
    np.testing.assert_array_equal(_u32(bits.numpy()),
                                  np.asarray(jbits, np.uint32))
    live = _live(rng, deleted=True)
    got = tre._pack_live_bits(torch.from_numpy(live))
    want = jre._pack_live_bits(jnp.asarray(live))
    np.testing.assert_array_equal(_u32(got.numpy()),
                                  np.asarray(want, np.uint32))


def test_tile_aux_rows_are_independent():
    """Row by row (the row chunks of a long doc axis) equals all at once."""
    bank = torch.from_numpy(_bank(np.random.default_rng(4), 9))
    want = tre.build_tile_aux(bank)
    ub, bits = [], []
    for r in range(9):
        u, b = tre.build_tile_aux(bank[r : r + 1])
        ub.append(u)
        bits.append(b)
    assert torch.equal(torch.cat(ub), want[0])
    assert torch.equal(torch.cat(bits), want[1])


def _both(heavy, light, live, hidx, lidx, B):
    t = torch.from_numpy
    hub, hbits = tre.build_tile_aux(t(heavy))
    lub, lbits = tre.build_tile_aux(t(light))
    got = tre.row_score_topk_pruned_or(
        t(heavy), t(light), hub, lub, hbits, lbits, t(live),
        tre._pack_live_bits(t(live)), t(hidx), t(lidx), k=K, B=B,
    ).numpy()
    j = jnp.asarray
    jhub, jhbits = jre.build_tile_aux(j(heavy))
    jlub, jlbits = jre.build_tile_aux(j(light))
    want = np.asarray(jre.row_score_topk_pruned_or(
        j(heavy), j(light), jhub, jlub, jhbits, jlbits, j(live),
        jre._pack_live_bits(j(live)), j(hidx), j(lidx), k=K, B=B,
    ))
    return got, want


@pytest.mark.parametrize("deleted", [False, True])
@pytest.mark.parametrize("B", [3, 8, 16, 40])
@pytest.mark.parametrize("Q", [1, 2, 3, 5, 7])
def test_pruned_or_rows_equal_jax(Q, B, deleted):
    """B < G (certificates decide) and B >= G (every tile rescored, always
    safe); tied tile maxima; deleted and padded docs."""
    rng = np.random.default_rng(100 * Q + B + deleted)
    heavy = _bank(rng, 12, tied_rows=3)
    light = _bank(rng, 6, tied_rows=2, zero_first=True)
    live = _live(rng, deleted)
    hidx, lidx = _plans(rng, Q, 8, 12, 6)
    got, want = _both(heavy, light, live, hidx, lidx, B)
    assert got.shape == want.shape == (Q, 2 * K + 2)
    np.testing.assert_array_equal(_u32(got), _u32(want))


@pytest.mark.parametrize("B", [2, 16])
@pytest.mark.parametrize("Q", [1, 4, 7])
def test_pruned_or_rows_equal_jax_light_small(Q, B):
    """A light bank of its zero row alone: light clauses add zeros."""
    rng = np.random.default_rng(7 * Q + B)
    heavy = _bank(rng, 9, tied_rows=2)
    light = np.zeros((1, D), np.float32)
    live = _live(rng, deleted=True)
    hidx, lidx = _plans(rng, Q, 12, 9, 1)
    got, want = _both(heavy, light, live, hidx, lidx, B)
    np.testing.assert_array_equal(_u32(got), _u32(want))


def test_pruned_or_rows_tied_everywhere():
    """Every tile of every row holds the same maximum: selection and rank
    break all ties toward the lower tile and docid."""
    rng = np.random.default_rng(12)
    heavy = np.zeros((4, D), np.float32)
    heavy[:, ::3] = 1.0
    light = np.zeros((2, D), np.float32)
    light[1, 1::5] = 1.0
    live = _live(rng, deleted=False)
    hidx = np.asarray([[0, 1, -1, -1], [2, -1, 3, -1]], np.int32)
    lidx = np.asarray([[0, 0, 1, 0], [0, 1, 0, 0]], np.int32)
    for B in (1, 2, 5, 16):
        got, want = _both(heavy, light, live, hidx, lidx, B)
        np.testing.assert_array_equal(_u32(got), _u32(want))


# ---------------------------------------------------------------------------
# The searcher on the route (tests/unit/test_pruned_engine.py, approx_min_q
# = 1000)
# ---------------------------------------------------------------------------


def _corpus(n_docs=900, vocab=60, seed=11, delete_every=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    words = np.asarray(
        [f"w{i}" for i in range(vocab)] + ["oil", "price", "trade", "rare1"],
        dtype=object,
    )
    mem = MemoryIndex()
    for i in range(n_docs):
        ln = max(3, int(rng.normal(20, 8)))
        toks = list(rng.choice(words, ln))
        if i % 317 == 0:
            toks.append("rare1")
        mem.add_document(Document().add(TextField("body", " ".join(toks))))
    seg = flush_memory_index(mem, "_pr")
    if delete_every:
        for d in range(0, n_docs, delete_every):
            seg.delete_document(d)
    return seg


def _force_pruned(searcher, b0, approx_min_q=1000):
    exs = [e for e in searcher._ctx("body").row_executors if e is not None]
    for ex in exs:
        ex.prune_min_docs = 0
        ex.prune_solo_min_docs = 0
        ex.prune_B0 = b0
        ex.approx_min_q = approx_min_q
    return exs


def _or_query(terms):
    b = BooleanQuery.Builder()
    for t in terms:
        b.add(TermQuery("body", t), Occur.SHOULD)
    return b.build()


QUERIES = [
    ["oil"],
    ["oil", "price"],
    ["oil", "price", "trade", "w1", "w2"],
    ["rare1"],
    ["rare1", "oil"],
    ["zzz_missing", "oil"],
    [f"w{i}" for i in range(20)],
]


def _same(got, want, what):
    assert got.total_hits == want.total_hits, what
    assert [d.doc for d in got.score_docs] == [d.doc for d in want.score_docs], what
    a = np.asarray([d.score for d in got.score_docs], np.float32)
    b = np.asarray([d.score for d in want.score_docs], np.float32)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), what


def _pair(seg, b0):
    port = IndexSearcher([segment_from_jax(seg)], device="cpu")
    (ex,) = _force_pruned(port, b0)
    jax_s = JaxSearcher([seg])
    _force_pruned(jax_s, b0)
    return port, ex, jax_s


@pytest.mark.parametrize("b0", [2, 8, 10_000])
def test_solo_parity_with_jax_and_oracle(b0):
    """Solo pure-OR searches take the tile-UB route in both packages
    ([1, 2k+2] rows; no compact bank) and equal the oracle."""
    seg = _corpus()
    port, ex, jax_s = _pair(seg, b0)
    oracle = OracleSearcher([seg])
    before = ex.metrics["pruned"].value()
    for terms in QUERIES:
        q = _or_query(terms)
        want = oracle.search(q, K)
        _same(port.search(query_from_jax(q), K), want, ("port", terms))
        _same(jax_s.search(q, K), want, ("jax", terms))
        plan = port._query_plans(query_from_jax(q))[1][0]
        assert ex.dispatch([plan], K).shape == (1, 2 * K + 2), terms
        assert not ex._entry([plan]).compact_built, terms
    assert ex.metrics["pruned"].value() - before >= 2 * len(QUERIES)


@pytest.mark.parametrize("b0", [2, 64])
def test_batch_and_async_paths(b0):
    """A batch of 7 pure-OR plans (< approx_min_q) on the tile-UB route,
    through search_batch, dispatch_batch + collect_batch and collect_many:
    equal to the oracle and the JAX searcher."""
    seg = _corpus(n_docs=700, seed=5)
    port, ex, jax_s = _pair(seg, b0)
    oracle = OracleSearcher([seg])
    queries = [_or_query(t) for t in QUERIES]
    pq = [query_from_jax(q) for q in queries]
    plans = [port._query_plans(q)[1][0] for q in pq]
    assert ex.dispatch(plans, K).shape == (len(plans), 2 * K + 2)
    got_batch = port.search_batch(pq, K)
    got_async = port.collect_batch(port.dispatch_batch(pq, K))
    got_many = port.collect_many([port.dispatch_batch(pq, K)
                                  for _ in range(2)])
    want_jax = jax_s.search_batch(queries, K)
    for qi, q in enumerate(queries):
        want = oracle.search(q, K)
        _same(want_jax[qi], want, ("jax", QUERIES[qi]))
        for got in (got_batch[qi], got_async[qi], got_many[0][qi],
                    got_many[1][qi]):
            _same(got, want, QUERIES[qi])


def test_escalation_and_certificate_honest():
    """A starved tile budget fails certificates; finalize escalates them
    onto the exhaustive route and the answers stay exact."""
    seg = _corpus()
    port, ex, _ = _pair(seg, 2)
    oracle = OracleSearcher([seg])
    q = _or_query(["oil", "price", "trade"])
    plan = port._query_plans(query_from_jax(q))[1][0]
    fused = ex.dispatch([plan], K)
    assert fused.shape[-1] == 2 * K + 2
    before = ex.metrics["escalations"].value()
    got = port.search(query_from_jax(q), K)
    assert ex.metrics["escalations"].value() > before
    _same(got, oracle.search(q, K), "escalated")


def test_with_deletes():
    seg = _corpus(n_docs=600, seed=9, delete_every=7)
    port, ex, jax_s = _pair(seg, 8)
    oracle = OracleSearcher([seg])
    for terms in QUERIES:
        q = _or_query(terms)
        want = oracle.search(q, K)
        _same(port.search(query_from_jax(q), K), want, terms)
        _same(jax_s.search(q, K), want, ("jax", terms))


def test_default_knobs_route_solo_to_tile_ub():
    """At the JAX package's routing constants, a solo pure-OR query on a
    prunable segment of prune_solo_min_docs padded docs or more takes the
    tile-UB route in both packages (the constants are read, not set)."""
    seg = _corpus(n_docs=300, seed=3)
    port = IndexSearcher([segment_from_jax(seg)], device="cpu")
    jax_s = JaxSearcher([seg])
    pe = port._ctx("body").row_executors[0]
    je = jax_s._ctx("body").row_executors[0]
    assert (pe.approx_min_q, pe.prune_solo_min_docs, pe.batch_only_min_docs) \
        == (je.approx_min_q, je.prune_solo_min_docs, je.batch_only_min_docs)
    q = _or_query(["oil", "price"])
    plan = port._query_plans(query_from_jax(q))[1][0]
    assert pe.dispatch([plan], K).shape[-1] == 2 * K + 1  # below the floor
    # the segment as the route sees it at the floor: only its size moves
    for ex in (pe, je):
        ex.prune_min_docs = 0
        ex.prune_solo_min_docs = ex.index.num_docs_pad
    jplan = jax_s._cached_query_plans(q)[1][0]
    assert pe.dispatch([plan], K).shape[-1] == 2 * K + 2
    assert np.asarray(je.dispatch([jplan], K)).shape[-1] == 2 * K + 2
