"""The port's on-demand scale mode against the JAX package's, bit for bit:
no resident heavy bank, compact banks scatter-built per batch in row
groups, exhaustive scoring / counts / escalations on a bank of the batch's
heavy rows, the phase-1 replay, and the opt-in phase 0 (tile maxima and
the bitmap hit counts of B8). Mirrors ``tests/unit/test_on_demand_bank.py``:
the on-demand threshold is patched down to 512 docs in both packages and
the row-group sizes down, so a 900-doc corpus runs every path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search import row_engine as jre
from diagon_tpu.search.oracle import OracleSearcher
from diagon_tpu.search.query import BooleanClause, BooleanQuery, Occur, TermQuery
from diagon_tpu.search.searcher import IndexSearcher as JaxSearcher
from diagon_tpu_torch.search import IndexSearcher
from diagon_tpu_torch.search import row_engine as tre
from diagon_tpu_torch.search.convert import query_from_jax, segment_from_jax

K = 10
M, S, F, N = Occur.MUST, Occur.SHOULD, Occur.FILTER, Occur.MUST_NOT


def T(w):
    return TermQuery("body", w)


def B(*clauses, ms=0):
    return BooleanQuery([BooleanClause(q, o) for q, o in clauses], ms)


def OR(*terms):
    return B(*[(T(t), S) for t in terms])


@pytest.fixture(scope="module")
def seg():
    rng = np.random.Generator(np.random.PCG64(11))
    words = np.asarray(
        [f"w{i}" for i in range(30)] + ["oil", "price", "trade", "rare1"],
        dtype=object,
    )
    mem = MemoryIndex()
    for i in range(900):
        toks = list(rng.choice(words, max(3, int(rng.normal(20, 8)))))
        if i % 317 == 0:
            toks.append("rare1")
        mem.add_document(Document().add(TextField("body", " ".join(toks))))
    return flush_memory_index(mem, "_od")


@pytest.fixture(scope="module")
def oracle(seg):
    return OracleSearcher([seg])


@pytest.fixture()
def od(seg, monkeypatch):
    """(port searcher, JAX searcher) in on-demand mode, pruning forced at
    every size and batch length; row groups of 4 rows in both packages."""
    monkeypatch.setattr(jre.RowFieldIndex, "ON_DEMAND_MIN_DOCS", 512)
    monkeypatch.setattr(jre, "_FLAT_SCATTER_MAX", 5 * 1024)
    monkeypatch.setattr(tre.RowFieldIndex, "ON_DEMAND_MIN_DOCS", 512)
    monkeypatch.setattr(tre, "_ROW_GROUP_ROWS", 4)
    port = IndexSearcher([segment_from_jax(seg)], device="cpu")
    jax_s = JaxSearcher([seg])
    for s in (port, jax_s):
        for ex in s._ctx("body").row_executors:
            ex.prune_min_docs = 0
            ex.prune_solo_min_docs = 0
            ex.approx_min_q = 1
    return port, jax_s


def _ex(searcher):
    return searcher._ctx("body").row_executors[0]


def _same(got, want, what):
    assert got.total_hits == want.total_hits, what
    assert [d.doc for d in got.score_docs] == [d.doc for d in want.score_docs], what
    a = np.asarray([d.score for d in got.score_docs], np.float32)
    b = np.asarray([d.score for d in want.score_docs], np.float32)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), what


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _batch(port, jax_s, oracle, queries):
    """dispatch_batch + collect_batch on both searchers, each result equal
    to the other's and to the oracle's."""
    got = port.collect_batch(
        port.dispatch_batch([query_from_jax(q) for q in queries], K))
    want = jax_s.collect_batch(jax_s.dispatch_batch(queries, K))
    for q, g, w in zip(queries, got, want):
        _same(g, w, ("port vs jax", q))
        _same(g, oracle.search(q, K), ("port vs oracle", q))
    return got


def _counts(ex):
    return {n: c.value() for n, c in ex.metrics.items()}


BATCH = [
    OR("oil", "price"),
    OR("w0", "w1", "w2", "trade"),
    T("w5"),
    B((T("w3"), M), (T("oil"), S)),
    B(*[(T(t), S) for t in ("w1", "w2", "w4", "price")], ms=2),
] * 3

PHASE0_BATCH = [
    OR("oil", "price", "w7"),
    T("trade"),
    B((T("w3"), M), (T("oil"), S), (T("w9"), S)),
    B((T("w1"), F), (T("price"), S)),  # FILTER: score-0 matches
    B((T("w2"), M), (T("rare1"), N)),
    B((T("zz_absent"), M), (T("oil"), S)),  # dead: absent required clause
    B((T("oil"), S), (T("w4"), S), (T("w6"), N)),
] * 2


def test_on_demand_mode_active(od):
    port, jax_s = od
    pi, ji = _ex(port).index, _ex(jax_s).index
    assert pi.bank_on_demand and ji.bank_on_demand
    assert pi.heavy_bank is None
    assert (pi.heavy_row_of_term >= 0).any()
    np.testing.assert_array_equal(pi.heavy_row_of_term, ji.heavy_row_of_term)
    np.testing.assert_array_equal(pi.heavy_tid_of_row, ji.heavy_tid_of_row)
    np.testing.assert_array_equal(_bits(pi.heavy_weight), _bits(ji.heavy_weight))


@pytest.mark.parametrize("query", [
    T("oil"), T("rare1"), OR("oil", "price", "w0", "w7"),
    B((T("oil"), M), (T("price"), S), (T("rare1"), N)),
], ids=["term", "rare", "or4", "must_should_not"])
def test_single_queries_bit_exact(od, oracle, query):
    port, jax_s = od
    got = port.search(query_from_jax(query), K)
    _same(got, jax_s.search(query, K), "port vs jax")
    _same(got, oracle.search(query, K), "port vs oracle")


def test_solo_pure_or_takes_the_batch_route(od):
    """On an on-demand segment every pure-OR batch takes the batch route,
    a one-query batch included, as in the JAX package. (The JAX package
    builds no compact bank for it below batch_only_min_docs, a size an
    on-demand segment reaches only with the threshold patched down, so
    both run at that size here.)"""
    port, jax_s = od
    for s in (port, jax_s):
        _ex(s).batch_only_min_docs = 1024
        _ex(s).approx_min_q = 8
    q = OR("oil", "price", "w3")
    widths = []
    for s, plan in ((port, port._query_plans(query_from_jax(q))[1][0]),
                    (jax_s, jax_s._cached_query_plans(q)[1][0])):
        widths.append(_ex(s).dispatch([plan], K).shape[-1])
    assert widths == [2 * K + 2, 2 * K + 2]


def test_batch_bit_exact(od, oracle):
    port, jax_s = od
    before = _counts(_ex(port))
    _batch(port, jax_s, oracle, BATCH)
    assert _counts(_ex(port))["pruned"] > before["pruned"]


def test_phase0_engages_and_bit_exact(od, oracle, monkeypatch):
    """With use_phase0, a min_should <= 1 batch builds phase-0 entries
    (tile maxima and bitmaps, no bf16 bank) and counts its hits with B8,
    bit-exact with the JAX package's phase 0 and the oracle, FILTER,
    MUST_NOT and a dead query included."""
    port, jax_s = od
    _ex(port).use_phase0 = True
    _ex(jax_s).use_phase0 = True
    calls = []
    real = tre.bits_hits

    def spy(*args):
        calls.append(tuple(args[1].shape))
        return real(*args)

    monkeypatch.setattr(tre, "bits_hits", spy)
    _batch(port, jax_s, oracle, PHASE0_BATCH)
    assert calls
    compacts = [e.compact for e in _ex(port)._batch_cache.values()
                if e.compact is not None]
    assert compacts
    for c in compacts:
        assert c.ubank is not None and c.compact_bf16 is None
        assert c.bits is not None and c.qmode is not None
    qmodes = torch.cat([c.qmode for c in compacts])
    assert bool(((qmodes & tre.MODE_DEAD) != 0).any())


def test_phase0_ineligible_batch_takes_phase1(od, oracle):
    """A plan with min_should >= 2 keeps the whole batch on phase 1 (the
    JAX package's routing), counted as phase0_ineligible."""
    port, jax_s = od
    _ex(port).use_phase0 = True
    _ex(jax_s).use_phase0 = True
    before = _counts(_ex(port))
    _batch(port, jax_s, oracle, BATCH)  # holds a min_should = 2 query
    assert _counts(_ex(port))["phase0_ineligible"] > before["phase0_ineligible"]
    assert any(e.compact is not None and e.compact.ubank is None
               and e.compact.compact_bf16 is not None
               for e in _ex(port)._batch_cache.values())


def test_count_and_escalation(od, oracle):
    """count() and escalation read the batch's on-demand heavy bank."""
    port, jax_s = od
    for q in (OR("oil", "price", "w0"), B((T("oil"), M), (T("w2"), N))):
        assert port.count(query_from_jax(q)) == oracle.count(q)
    for s in (port, jax_s):
        _ex(s).prune_B0 = 1
    before = _counts(_ex(port))
    q = OR("oil", "price", "trade", "w2")
    got = port.search(query_from_jax(q), 20)
    _same(got, jax_s.search(q, 20), "port vs jax")
    _same(got, oracle.search(q, 20), "port vs oracle")
    assert _counts(_ex(port))["escalations"] > before["escalations"]
    assert _ex(port)._demand_args_cache


@pytest.mark.parametrize("phase0", [False, True])
def test_escalated_batch_bit_exact(od, oracle, phase0):
    port, jax_s = od
    for s in (port, jax_s):
        _ex(s).prune_B0 = 1
        _ex(s).use_phase0 = phase0
    before = _counts(_ex(port))
    jbefore = _ex(jax_s).metrics["escalations"].value()
    _batch(port, jax_s, oracle, PHASE0_BATCH)
    escalated = _counts(_ex(port))["escalations"] - before["escalations"]
    assert escalated > 0
    # the same queries fail their certificates in both packages
    assert escalated == _ex(jax_s).metrics["escalations"].value() - jbefore


def test_p1_replay_skips_phase1(od, oracle, monkeypatch):
    """At batch_only_min_docs and more, a re-issued identical batch replays
    phase 1 from its entry (same bits, no phase-1 call); with query_cache
    off it runs phase 1 again."""
    port, jax_s = od
    for s in (port, jax_s):
        _ex(s).batch_only_min_docs = 1024
    calls = []
    real = tre._pruned_batch_phase1

    def spy(*args, **kw):
        calls.append(kw["Bk"])
        return real(*args, **kw)

    monkeypatch.setattr(tre, "_pruned_batch_phase1", spy)
    ex = _ex(port)
    queries = [query_from_jax(q) for q in BATCH]
    plans = [port._query_plans(q)[1][0] for q in queries]
    first = ex.dispatch(plans, K)
    n_first = len(calls)
    assert n_first > 0
    again = ex.dispatch(plans, K)
    assert len(calls) == n_first
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    _batch(port, jax_s, oracle, BATCH)
    ex.query_cache = False
    ex.dispatch(plans, K)
    assert len(calls) > n_first


def test_compact_banks_equal_resident_build(seg):
    """The on-demand compact banks (grouped scatter builds) equal the
    resident-mode assembly for the same plans, bit for bit."""
    resident = IndexSearcher([segment_from_jax(seg)], device="cpu")
    rex = _ex(resident)
    queries = [query_from_jax(q) for q in BATCH + PHASE0_BATCH]
    plans_r = [resident._query_plans(q)[1][0] for q in queries]
    want = rex._build_compact(rex._entry(plans_r))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tre.RowFieldIndex, "ON_DEMAND_MIN_DOCS", 512)
        mp.setattr(tre, "_ROW_GROUP_ROWS", 3)
        od = IndexSearcher([segment_from_jax(seg)], device="cpu")
        oex = _ex(od)
        plans_o = [od._query_plans(q)[1][0] for q in queries]
        got = oex._build_compact(oex._entry(plans_o))
    assert torch.equal(got.compact_t.view(torch.int32),
                       want.compact_t.view(torch.int32))
    assert torch.equal(got.compact_bf16.view(torch.int16),
                       want.compact_bf16.view(torch.int16))
    assert torch.equal(got.cidx, want.cidx)


def test_build_rows_grouped_equals_host_rows(od, seg):
    port, _ = od
    idx = _ex(port).index
    pp = seg.fields["body"].postings
    tids = np.asarray([pp.term_id(t) for t in
                       ("oil", "w1", "rare1", "price", "w9", "trade")] + [-1])
    weights = np.float32([1.5, 0.25, 3.0, 1.0, 2.0, 0.5, 1.0])
    seen = []
    for g0, rows in idx.build_rows_grouped(tids, weights):
        assert rows.shape[0] <= tre._ROW_GROUP_ROWS
        for j in range(rows.shape[0]):
            t = tids[g0 + j]
            want = (idx.host_row(int(t), weights[g0 + j]) if t >= 0
                    else np.zeros(idx.num_docs_pad, np.float32))
            np.testing.assert_array_equal(_bits(rows[j].numpy()), _bits(want))
            seen.append(g0 + j)
    assert seen == list(range(len(tids)))


def _tile_major_bank(rng, G, U8, density=0.2):
    ct = rng.random((G, U8, 128), dtype=np.float32) * 8
    ct *= rng.random((G, U8, 128)) < density
    ct[:, 0] = 0.0
    return ct


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ubank_and_bits_bank_equal_jax(seed):
    rng = np.random.default_rng(seed)
    G, U8 = 24, 16
    ct = _tile_major_bank(rng, G, U8)
    live = (rng.random(G * 128) < 0.9).astype(np.float32)
    got = tre._ubank_from_tiles(torch.from_numpy(ct))
    want = np.asarray(jre._ubank_from_tiles(jnp.asarray(ct)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    gotb = tre._build_bits_bank(torch.from_numpy(ct), torch.from_numpy(live))
    wantb = np.asarray(jre._build_bits_bank(jnp.asarray(ct), jnp.asarray(live)))
    np.testing.assert_array_equal(gotb.numpy().view(np.uint32), wantb)


@pytest.mark.parametrize("boolean", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pruned_batch_phase0_equals_jax(seed, boolean):
    rng = np.random.default_rng(10 + seed)
    G, U8, Q, Bk = 40, 24, 12, 6
    ubank = _tile_major_bank(rng, G, U8).max(axis=2).T.copy()
    ubank[:, rng.random(G) < 0.2] = 0.0  # tiles some rows miss
    a = {}
    for r in ("sc", "rq", "sh"):
        a[r] = (rng.random((U8, Q)) < 0.2).astype(np.float32)
        a[r][0] = 0.0
    params = np.zeros((8, Q), np.float32)
    params[0] = a["rq"].sum(axis=0)
    params[1] = np.where(params[0] > 0, 0.0, 1.0)
    got = tre._pruned_batch_phase0(
        *[torch.from_numpy(x) for x in (ubank, a["sc"], a["rq"], a["sh"], params)],
        Bk=Bk, boolean=boolean)
    want = jre._pruned_batch_phase0(
        *[jnp.asarray(x) for x in (ubank, a["sc"], a["rq"], a["sh"], params)],
        Bk=Bk, boolean=boolean)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
