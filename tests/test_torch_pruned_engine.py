"""The port's pruned batch route (phase 1, tile selection, phase 2,
certificates, escalation) against the JAX searcher under the same forced
pruning and against the host oracle: same docids, same f32 score bits,
same hits. Mirrors the ``_force_pruned`` cases of
``tests/unit/test_pruned_engine.py``.

Segments and queries are built with the JAX package and carried into the
port by ``convert``. The pruning counters live in the port's own registry,
one process-wide object per name, so every count here is a delta around
the port's own calls."""

import itertools

import numpy as np
import pytest
import torch

from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search.oracle import OracleSearcher
from diagon_tpu.search.query import BooleanClause, BooleanQuery, Occur, TermQuery
from diagon_tpu.search.searcher import IndexSearcher as JaxSearcher
from diagon_tpu_torch.search import IndexSearcher
from diagon_tpu_torch.search import row_engine as re
from diagon_tpu_torch.search.convert import query_from_jax, segment_from_jax

K = 10
M, S, F, N = Occur.MUST, Occur.SHOULD, Occur.FILTER, Occur.MUST_NOT


def _corpus(n_docs, seed, vocab=60, delete_every=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    words = np.asarray(
        [f"w{i}" for i in range(vocab)] + ["oil", "price", "trade", "rare1"],
        dtype=object,
    )
    mem = MemoryIndex()
    for i in range(n_docs):
        toks = list(rng.choice(words, max(3, int(rng.normal(20, 8)))))
        if i % 317 == 0:
            toks.append("rare1")
        mem.add_document(Document().add(TextField("body", " ".join(toks))))
    seg = flush_memory_index(mem, f"_p{seed}")
    if delete_every:
        for d in range(0, n_docs, delete_every):
            seg.delete_document(d)
    return seg


def _port(seg):
    return IndexSearcher([segment_from_jax(seg)], device="cpu")


def _plans(port, queries):
    """The port's plans (segment 0) for JAX package queries."""
    return [port._query_plans(query_from_jax(q))[1][0] for q in queries]


def _force_pruned(searcher, b0, approx_min_q=1):
    exs = [e for e in searcher._ctx("body").row_executors if e is not None]
    for ex in exs:
        ex.prune_min_docs = 0
        ex.prune_solo_min_docs = 0
        ex.prune_B0 = b0
        ex.approx_min_q = approx_min_q
    return exs


def T(w):
    return TermQuery("body", w)


def B(*clauses, ms=0):
    return BooleanQuery([BooleanClause(q, o) for q, o in clauses], ms)


def OR(*terms):
    return B(*[(T(t), S) for t in terms])


OR_QUERIES = [
    OR("oil"), OR("oil", "price"), OR("oil", "price", "trade", "w1", "w2"),
    OR("rare1"), OR("rare1", "oil"), OR("zzz_missing", "oil"),
    OR(*[f"w{i}" for i in range(20)]), T("w7"),
]
BOOL_QUERIES = [
    B((T("oil"), M), (T("price"), M)),
    B((T("oil"), M), (T("w1"), S), (T("w2"), S)),
    B((T("oil"), F), (T("price"), S)),
    B((T("oil"), S), (T("price"), S), (T("trade"), S), ms=2),
    B((T("zzz_missing"), M), (T("oil"), S)),
    B((T("oil"), F)),  # FILTER-only: score-0 matches
    B((T("trade"), M), (T("w5"), S), (T("w6"), S), ms=1),
]
NEG_QUERIES = [
    B((T("oil"), S), (T("price"), S), (T("w3"), N)),
    B((T("oil"), M), (T("w4"), N), (T("w5"), N)),
    B((T("price"), F), (T("trade"), S), (T("w9"), N)),
]


@pytest.fixture(scope="module")
def seg():
    return _corpus(1900, seed=11)


@pytest.fixture(scope="module")
def oracle(seg):
    return OracleSearcher([seg])


def _same(got, want, what):
    assert got.total_hits == want.total_hits, what
    assert [d.doc for d in got.score_docs] == [d.doc for d in want.score_docs], what
    a = np.asarray([d.score for d in got.score_docs], np.float32)
    b = np.asarray([d.score for d in want.score_docs], np.float32)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), what


def _counts(ex):
    return {n: c.value() for n, c in ex.metrics.items()}


def _delta(before, ex):
    return {n: c.value() - before[n] for n, c in ex.metrics.items()}


def _run_three(seg, oracle, queries, b0, **knobs):
    """Batch + solo through the port, batch through the JAX searcher, each
    forced onto the pruned route; all equal to the oracle. Returns the
    port's counter deltas."""
    port = _port(seg)
    (ex,) = _force_pruned(port, b0)
    for name, v in knobs.items():
        setattr(ex, name, v)
    jax_s = JaxSearcher([seg])
    _force_pruned(jax_s, b0)
    before = _counts(ex)
    pq = [query_from_jax(q) for q in queries]
    got = port.search_batch(pq, K)
    solo = [port.search(q, K) for q in pq]
    delta = _delta(before, ex)
    want_jax = jax_s.search_batch(queries, K)
    for i, q in enumerate(queries):
        want = oracle.search(q, K)
        _same(got[i], want, ("port batch", q))
        _same(solo[i], want, ("port solo", q))
        _same(want_jax[i], want, ("jax batch", q))
    return delta


@pytest.mark.parametrize("b0", [2, 10_000])
@pytest.mark.parametrize("family", ["or", "bool", "neg"])
def test_pruned_parity_with_jax_and_oracle(seg, oracle, family, b0):
    """Pure-OR (B3), no-MUST_NOT boolean (B5) and MUST_NOT (B4) batches;
    a starved tile budget escalates, a generous one certifies."""
    queries = {"or": OR_QUERIES, "bool": BOOL_QUERIES,
               "neg": NEG_QUERIES + BOOL_QUERIES[:3]}[family]
    delta = _run_three(seg, oracle, queries, b0)
    assert delta["pruned"] > 0
    if b0 == 2:
        assert delta["escalations"] > 0
    else:
        assert delta["escalations"] == 0


def test_pruned_with_deletes(oracle):
    seg = _corpus(1500, seed=9, delete_every=7)
    _run_three(seg, OracleSearcher([seg]),
               OR_QUERIES[:5] + BOOL_QUERIES[:4] + NEG_QUERIES[:1], 4)


def test_phase1_kernel_choice(seg):
    """A no-MUST_NOT boolean batch carries the combined indicator (B5); a
    batch with MUST_NOT, or a row in both required and should roles of one
    query, does not (B4); pure-OR batches never do (B3)."""
    port = _port(seg)
    (ex,) = _force_pruned(port, 16)

    def compact_of(queries):
        return ex._compact(_plans(port, queries))

    assert compact_of(BOOL_QUERIES).a_cb_t is not None
    assert compact_of(NEG_QUERIES).a_cb_t is None
    assert compact_of([B((T("oil"), M), (T("oil"), S), (T("price"), S))]
                      ).a_cb_t is None
    assert compact_of(OR_QUERIES).a_cb_t is None


def test_purity_split_keeps_query_order(seg, oracle):
    queries = [q for pair in zip(OR_QUERIES, BOOL_QUERIES + NEG_QUERIES)
               for q in pair]
    port = _port(seg)
    (ex,) = _force_pruned(port, 16)
    plans = _plans(port, queries)
    fused = ex.dispatch(plans, K)
    assert fused.shape == (len(queries), 2 * K + 2)
    assert ex._split_cache[tuple(map(id, plans))]
    pq = [query_from_jax(q) for q in queries]
    res = port.collect_many([port.dispatch_batch(pq, K)])[0]
    for q, r in zip(queries, res):
        _same(r, oracle.search(q, K), q)


def test_partitions_and_compact_fallback(seg, oracle):
    """A small compact cap partitions a diverse batch into query groups,
    and a query whose rows alone exceed COMPACT_MAX_ROWS takes the
    exhaustive fallback; both stay exact."""
    queries = OR_QUERIES + [OR(*[f"w{i}" for i in range(30, 45)])]
    delta = _run_three(seg, oracle, queries, 8, COMPACT_MAX_ROWS=8)
    assert delta["partitions"] > 0
    assert delta["compact_fallbacks"] > 0
    assert delta["pruned"] > 0


def test_routing_matches_jax(seg):
    """Which batches take the pruned route ([Q, 2k+2] rows) at the JAX
    package's knobs: the same in both packages, small pure-OR batches on
    the tile-UB route included."""
    port = _port(seg)
    jax_s = JaxSearcher([seg])
    pe = port._ctx("body").row_executors[0]
    je = jax_s._ctx("body").row_executors[0]
    for ex in (pe, je):
        ex.prune_min_docs = 0

    def width(searcher, ex, queries):
        if searcher is port:
            plans = _plans(port, queries)
        else:
            plans = [searcher._cached_query_plans(q)[1][0] for q in queries]
        return ex.dispatch(plans, K).shape[-1]

    cases = [
        [OR_QUERIES[2]] * 3,  # dedups to one plan below the solo floor
        OR_QUERIES,  # 8 distinct pure-OR plans
        OR_QUERIES[:4] + BOOL_QUERIES[:4],  # purity split
        BOOL_QUERIES[:3],  # small boolean batch
        [OR_QUERIES[1], OR_QUERIES[1], OR_QUERIES[3]],
    ]
    for queries in cases:
        assert width(port, pe, queries) == width(jax_s, je, queries), queries
    for ex in (pe, je):
        ex.prune_solo_min_docs = 0
    small = OR_QUERIES[:3]
    assert width(jax_s, je, small) == 2 * K + 2  # JAX: tile-UB path
    assert width(port, pe, small) == 2 * K + 2  # port: tile-UB path
    dup = [OR_QUERIES[1], OR_QUERIES[1], OR_QUERIES[3]]  # forced batch
    assert width(port, pe, dup) == width(jax_s, je, dup) == 2 * K + 2


def test_assemble_compact_layout():
    """Row 0 zero, the used heavy rows in ascending order, the light rows,
    zero rows up to a multiple of 8 (test_assemble_compact's layout)."""
    rng = np.random.default_rng(3)
    heavy = torch.from_numpy(rng.random((70, 256), dtype=np.float32))
    light = torch.from_numpy(rng.random((6, 256), dtype=np.float32))
    for n_used, n_light in [(0, 0), (1, 0), (0, 1), (5, 3), (31, 0), (7, 5)]:
        used = np.sort(rng.choice(70, n_used, replace=False))
        got = re._assemble_compact(heavy, used, light, n_light)
        n_rows = 1 + n_used + n_light
        assert got.shape == (-(-n_rows // 8) * 8, 256)
        want = torch.zeros_like(got)
        want[1 : 1 + n_used] = heavy[used]
        want[1 + n_used : n_rows] = light[1 : 1 + n_light]
        assert torch.equal(got, want)
        tm = re._tile_major(got)
        assert torch.equal(tm.permute(1, 0, 2).reshape(got.shape), got)


def test_finalize_escalates_in_chunks(seg, oracle, monkeypatch):
    """Escalation reruns the failed queries exhaustively in chunks of
    EXHAUSTIVE_CHUNK_BYTES / (4 D) queries; the results do not depend on
    the chunk."""
    port = _port(seg)
    (ex,) = _force_pruned(port, 2)
    monkeypatch.setattr(ex, "EXHAUSTIVE_CHUNK_BYTES",
                        2 * 4 * ex.index.num_docs_pad)
    queries = OR_QUERIES + BOOL_QUERIES
    before = _counts(ex)
    res = port.search_batch([query_from_jax(q) for q in queries], K)
    assert _delta(before, ex)["escalations"] > 2
    for q, r in zip(queries, res):
        _same(r, oracle.search(q, K), q)


def _short_queries(family, n=72):
    """``n`` distinct queries of 2-3 clauses (Tq = 4), the class the JAX
    package sends to its union rescore."""
    out = []
    for i, (x, y, z) in enumerate(itertools.combinations(range(12), 3)):
        if i == n:
            break
        a, b, c = f"w{x}", f"w{y}", f"w{z}"
        if family == "or":
            out.append(OR(a, b, c))
        elif family == "bool":
            out.append(B((T(a), M), (T(b), S), (T(c), S)))
        else:
            out.append(B((T(a), S), (T(b), S), (T(c), N)))
    return out


@pytest.mark.parametrize("family", ["or", "bool", "neg"])
def test_union_route_parity_with_jax_and_oracle(seg, oracle, family,
                                                monkeypatch):
    """Batches of 64+ queries with at most 8 clauses take B7 (the union
    rescore), as the JAX package routes them; results equal the JAX
    searcher's and the oracle's. Solo queries keep B6."""
    seen = []
    real = re.union_rescore

    def spy(*args):
        seen.append(tuple(args[2].shape))
        return real(*args)

    monkeypatch.setattr(re, "union_rescore", spy)
    delta = _run_three(seg, oracle, _short_queries(family), 4)
    assert delta["pruned"] > 0
    assert seen and all(q >= 64 for q, _ in seen)


def test_compact_bank_built_only_where_read(seg):
    """An exhaustive batch builds no compact bank; the pruned route builds
    one on its entry; escalation chunks build none."""
    port = _port(seg)
    ex = port._ctx("body").row_executors[0]
    plans = _plans(port, BOOL_QUERIES)
    assert ex.dispatch(plans, K).shape[-1] == 2 * K + 1  # below 16,384 docs
    entry = ex._entry(plans)
    assert not entry.compact_built
    _force_pruned(port, 2)
    fused = ex.dispatch(plans, K)
    assert ex._entry(plans) is entry
    assert entry.compact_built and entry.compact is not None
    before = _counts(ex)
    ex.finalize(plans, fused, K)
    assert _delta(before, ex)["escalations"] > 0
    others = [e for e in ex._batch_cache.values() if e is not entry]
    assert others and not any(e.compact_built for e in others)
