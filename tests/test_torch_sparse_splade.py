"""The SPLADE configuration of the benchmark (``gpubench/``) on the CPU at a
tiny size: its generator, the adapter to the port's ``SparseSearcher``
(batch path) and the plain reference (``gpubench/reference/splade_dot.py``)
give equal answers (hits, doc ids, f32 score bits), with absent terms,
ties and a partitioned batch; the bfloat16 control is rejected;
``SparseIndex.from_csr`` is the JAX package's build; the ``plan``,
``route`` and ``light`` spans and the ``search.light_rows`` and
``search.compact_groups`` counters count what they name; the generated
shapes are the configuration's; the generator and the reference load
without the program."""

import copy
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "gpubench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from diagon_tpu.sparse import SparseIndex as JaxIndex  # noqa: E402
from diagon_tpu.sparse import SparseVector as JaxVector  # noqa: E402
from diagon_tpu_torch.codecs.postings import PackedPostings  # noqa: E402
from diagon_tpu_torch.observability.metrics import registry  # noqa: E402
from diagon_tpu_torch.observability.profiler import QueryProfiler  # noqa: E402
from diagon_tpu_torch.sparse import SparseIndex, SparseVector  # noqa: E402
from harness import check  # noqa: E402
from harness.sparse_corpus import SparseCorpus, make_corpus  # noqa: E402
from harness.sparse_system import System, to_vector  # noqa: E402
from harness.splade_queries import draw_queries, table  # noqa: E402
from reference.splade_dot import Reference, parse_clause  # noqa: E402

CFG = json.loads((BENCH / "configs" / "msmarco-splade-1.1m.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "splade-dev-b256.json").read_text())
TINY = dict(CFG, num_docs=3000, vocab_size=512, dev_queries=64)
SEEDS = [2**31 + 977, 7, 2**40 + 3]
K = 10


def _specs(cfg, absent=()):
    """The table's specs for ``cfg``; ``absent`` ids, which no passage
    holds, are added to every other query, and one query holds them
    alone."""
    specs = []
    for i, e in enumerate(table(cfg)):
        should = list(e["should"])
        if absent and i % 2:
            should += [f"{t}^0.75" for t in absent]
        specs.append(("bool", (), tuple(should), ()))
    if absent:
        specs.append(("bool", (), tuple(f"{t}^1.5" for t in absent), ()))
    return specs


def _answers(system, specs):
    qs = [System.fresh(q) for q in System.queries(specs, "splade")]
    return [System.answer(r)
            for r in system.collect(system.dispatch(qs, K))]


def _assert_equal(got, want):
    numbers = check.compare(got, want, 0)
    assert numbers["wrong_answers"] == 0 and numbers["score_gap"] == 0.0
    for (_, _, s), (_, _, r) in zip(got, want):  # f32 bits, not only values
        assert np.array_equal(np.asarray(s, np.float32).view(np.uint32),
                              np.asarray(r, np.float32).view(np.uint32))


def _tiny(seed, cfg=TINY):
    corpus = make_corpus(cfg, seed, "cpu")
    return corpus, System(corpus, "cpu"), Reference.for_corpus(
        corpus, "splade", cfg, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_answers_equal_the_reference(seed):
    """Every query of a 64-query table over 3,000 passages, absent terms
    among them: hits, doc ids and f32 score bits equal the reference's."""
    corpus, system, ref = _tiny(seed)
    absent = (600, 4097)  # ids past the tiny vocabulary
    specs = _specs(TINY, absent)
    got, want = _answers(system, specs), ref.answer(specs, K)
    _assert_equal(got, want)
    assert got[-1] == (0, (), ())  # absent terms alone
    assert all(h > 0 for h, _, _ in got[:-1])


def _tie_corpus():
    """Passages 3, 5 and 9 are copies of one passage; every other one
    holds a disjoint term."""
    rows = [([100 + d], [0.5]) for d in range(12)]
    for d in (3, 5, 9):
        rows[d] = ([7, 11, 13], [0.25, 1.0, 2.0])
    rows[1] = ([7, 11], [0.5, 3.0])  # a larger max weight for 7 and 11
    indptr = np.cumsum([0] + [len(r[0]) for r in rows])
    ids = np.concatenate([r[0] for r in rows]).astype(np.int32)
    values = np.concatenate([r[1] for r in rows]).astype(np.float32)
    return SparseCorpus(len(rows), indptr, ids, values)


def test_equal_scores_go_to_the_lower_doc_id():
    corpus = _tie_corpus()
    system, ref = System(corpus, "cpu"), Reference.for_corpus(
        corpus, "splade", CFG, "cpu")
    specs = [("bool", (), ("7^1", "11^0.5", "13^2"), ()),
             ("bool", (), ("13^1",), ())]
    got, want = _answers(system, specs), ref.answer(specs, K)
    _assert_equal(got, want)
    hits, docs, scores = got[0]
    assert hits == 4 and docs[:3] == (3, 5, 9) and docs[3] == 1
    assert scores[0] == scores[1] == scores[2] > scores[3]
    assert got[1][1] == (3, 5, 9)


def _delta(before, names):
    after = registry.snapshot()
    return {n: after.get(n, 0) - before.get(n, 0) for n in names}


@pytest.fixture
def phases():
    """The thread's profiler, enabled for the test and off after it."""
    p = QueryProfiler.enable()
    yield p
    QueryProfiler._tls.profiler = QueryProfiler(enabled=False)


def _forced(system, group_bytes):
    """The pruned route's routing at the tiny size, and a compact cap of
    ``group_bytes / (10 bytes x padded docs)`` rows (32 at least), so the
    batch partitions as at 1.1M passages."""
    ex = system.searcher.executor
    ex.prune_min_docs = 0
    ex.COMPACT_GROUP_BYTES = group_bytes
    return ex


@pytest.mark.parametrize("seed", SEEDS)
def test_partitioned_batch_equals_the_reference(seed, phases):
    """A lowered COMPACT_GROUP_BYTES (the 1.1M shard's 194-row cap) splits
    the table's batch into query groups: more than one group, a ``light``
    span a group inside the one ``route``, the answers still exact."""
    corpus, system, ref = _tiny(seed)
    D = system.searcher.num_docs_pad
    ex = _forced(system, 194 * 10 * D)
    assert ex._compact_row_cap() == 194
    specs = _specs(TINY)
    before = registry.snapshot()
    got = _answers(system, specs)
    d = _delta(before, ("search.compact_groups", "search.light_rows"))
    _assert_equal(got, ref.answer(specs, K))
    groups = d["search.compact_groups"]
    assert groups > 1
    counts = {n: r["count"] for n, r in phases.report().items()}
    assert counts == {"plan": 1, "route": 1, "light": groups,
                      "finalize": 1, "copy": 1}
    assert phases.report()["light"]["total_us"] \
        <= phases.report()["route"]["total_us"]
    # the distinct clauses of each group: at most every clause, and fewer
    # only where two queries of a group share an id and its weight
    clauses = sum(len(s[2]) for s in specs)
    assert 0.97 * clauses <= d["search.light_rows"] <= clauses


def _disjoint_specs():
    """Eight queries of ten distinct clauses each, no clause shared."""
    rng = np.random.Generator(np.random.PCG64(1))
    ids = rng.permutation(512)[:80].reshape(8, 10)
    return [("bool", (), tuple(f"{t}^{0.5 + j / 8:.4g}" for t in row), ())
            for j, row in enumerate(ids)]


def test_counters_and_spans_equal_hand_counts(phases):
    """Eight queries of ten distinct clauses each, no clause shared, under
    the 32-row floor of the compact cap: groups of 3, 3 and 2 queries (31
    rows fit, 41 do not), so 3 groups and 80 light rows; one ``plan`` and
    one ``route`` a batch, a ``light`` span a group, nested in ``route``
    (its time inside the route's)."""
    corpus, system, ref = _tiny(SEEDS[0])
    _forced(system, 1)
    specs = _disjoint_specs()
    before = registry.snapshot()
    got = _answers(system, specs)
    assert _delta(before, ("search.compact_groups", "search.light_rows")) \
        == {"search.compact_groups": 3, "search.light_rows": 80}
    counts = {n: r["count"] for n, r in phases.report().items()}
    assert counts == {"plan": 1, "route": 1, "light": 3, "finalize": 1,
                      "copy": 1}
    _assert_equal(got, ref.answer(specs, K))
    # a second batch of the same queries: the counters add as much again
    before = registry.snapshot()
    _answers(system, specs)
    assert _delta(before, ("search.compact_groups", "search.light_rows")) \
        == {"search.compact_groups": 3, "search.light_rows": 80}


@pytest.mark.parametrize("budget, kept", [(1, False), (1 << 30, True)])
def test_partition_keeps_its_entries_only_where_they_all_fit(budget, kept):
    """The 3-group batch of the hand counts, its plans issued twice to the
    executor (the entry cache is keyed by plan identity; the searcher
    builds new plans for every batch). Where the groups' entries together
    overrun the entry cache's budget, none stays cached after the batch,
    and the re-issued batch decodes its 80 rows again (in the same group
    order an LRU would have evicted each entry before its turn); where
    they fit, all three stay and the re-issued batch decodes none. Exact
    answers either way."""
    corpus, system, ref = _tiny(SEEDS[0])
    ex = _forced(system, 1)
    ex.BATCH_CACHE_BUDGET = budget
    specs = _disjoint_specs()
    plans = system.searcher._plan_batch(System.queries(specs, "splade"))
    names = ("search.compact_groups", "search.light_rows")
    for rows in (80, 0 if kept else 80):
        before = registry.snapshot()
        scores, docs, hits = ex.finalize(plans, ex.dispatch(plans, K), K)
        got = [System.answer((s[:min(h, K)], d[:min(h, K)], h))
               for s, d, h in zip(scores, docs, hits)]
        assert _delta(before, names) == {"search.compact_groups": 3,
                                         "search.light_rows": rows}
        _assert_equal(got, ref.answer(specs, K))
        assert len(ex._batch_cache) == (3 if kept else 0)
        assert ex._batch_bytes == sum(e.nbytes
                                      for e in ex._batch_cache.values())


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_control_is_rejected(seed):
    """The reference in bfloat16 put in the program's place fails the
    comparison."""
    _, _, ref = _tiny(seed)
    specs = _specs(TINY)
    numbers = check.compare(ref.answer(specs, K, "bf16"), ref.answer(specs, K), 0)
    ok, _ = check.verdict(numbers)
    assert not ok
    assert numbers["wrong_answers"] > len(specs) // 2
    assert numbers["score_gap"] > 1e-3


def test_id_weight_clauses_parse():
    """``"<id>^<weight>"`` clauses: the id an int, the weight
    ``np.float32(float(text))``; the adapter's vectors hold the ids in
    ascending order; anything but a SHOULD list is refused."""
    spec = ("bool", (), ("30521^0.1", "5^2.5", "17^1.234e-2", "0^3"), ())
    v = to_vector(spec)
    assert v.ids.tolist() == [0, 5, 17, 30521]
    assert v.values.view(np.uint32).tolist() == np.asarray(
        [3.0, 2.5, 0.01234, 0.1], np.float32).view(np.uint32).tolist()
    assert parse_clause("17^1.234e-2") == (17, np.float32(0.01234))
    assert type(parse_clause("5^2.5")[1]) is np.float32
    with pytest.raises(ValueError):
        to_vector(("bool", ("5^1",), (), ()))
    with pytest.raises(ValueError):
        to_vector(("phrase", ("a", "b")))
    fresh = System.fresh(v)
    assert fresh is not v and fresh.ids is v.ids


def _vectors(rng, n, vocab):
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 40))
        ids = rng.choice(vocab, size=k, replace=False)
        out.append((ids, (rng.random(k) * 3 + 0.01).astype(np.float32)))
    return out


@pytest.mark.parametrize("vocab", [30522, 1 << 25])
def test_from_csr_is_the_jax_build(vocab):
    """``from_csr`` over the vectors' CSR packs the JAX package's blocks,
    with its scales and exact CSR, as ``build`` does; also with ids past
    2^24 (the ``np.unique`` branch)."""
    rng = np.random.Generator(np.random.PCG64(11))
    pairs = _vectors(rng, 400, vocab)
    vecs = [SparseVector(i, v) for i, v in pairs]
    indptr = np.cumsum([0] + [len(v) for v in vecs])
    csr = SparseIndex.from_csr(indptr, np.concatenate([v.ids for v in vecs]),
                               np.concatenate([v.values for v in vecs]))
    want = JaxIndex.build([JaxVector(i, v) for i, v in pairs])
    for got in (csr, SparseIndex.build(vecs)):
        g = got.segment.fields["_sparse"]
        w = want.segment.fields["_sparse"]
        for f in dataclasses.fields(PackedPostings):
            a, b = getattr(g.postings, f.name), getattr(w.postings, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
        np.testing.assert_array_equal(g.norms, w.norms)
        assert got.num_docs == want.num_docs == 400
        assert got.scales == want.scales
        assert got.exact.keys() == want.exact.keys()
        for key, (d, wt) in want.exact.items():
            np.testing.assert_array_equal(got.exact[key][0], d)
            np.testing.assert_array_equal(got.exact[key][1].view(np.uint32),
                                          wt.view(np.uint32))


def test_generated_shard_and_table_have_the_published_shape():
    """20,000 passages of the configuration: 119 mean non-zeros within 2%,
    ids distinct and ascending in a passage and below 30,522, weights
    positive; the committed table: 6,980 queries of 43 mean non-zeros
    within 2%, as its script writes it again."""
    cfg = dict(CFG, num_docs=20000)
    c = make_corpus(cfg, SEEDS[0], "cpu")
    nnz = np.diff(c.indptr)
    assert abs(nnz.mean() / 119 - 1) < 0.02
    assert nnz.min() >= CFG["doc_nnz_min"] and nnz.max() <= CFG["doc_nnz_max"]
    step = np.diff(c.ids.astype(np.int64))
    inner = np.ones(len(step), bool)
    inner[c.indptr[1:-1] - 1] = False  # a passage's last id to the next's first
    assert (step[inner] > 0).all()
    assert c.ids.min() >= 0 and c.ids.max() < 30522
    assert (c.values > 0).all() and c.values.dtype == np.float32
    rows = TRAFFIC["table"]
    assert len(rows) == CFG["dev_queries"] == 6980
    q = np.asarray([len(r["should"]) for r in rows])
    assert abs(q.mean() / 43 - 1) < 0.02
    assert TRAFFIC["table_mean_nnz"] == q.mean()
    assert rows == table(CFG)
    ids, ws = draw_queries(dict(CFG, dev_queries=5))[0]
    assert (np.diff(ids) > 0).all() and (ws > 0).all()


def test_corpus_follows_the_seed():
    """The same seed gives the same arrays; another seed the same passages
    in another order."""
    a = make_corpus(TINY, SEEDS[0], "cpu")
    b = make_corpus(TINY, SEEDS[0], "cpu")
    c = make_corpus(TINY, SEEDS[1], "cpu")
    for x in ("indptr", "ids", "values"):
        assert np.array_equal(getattr(a, x), getattr(b, x))
    assert not np.array_equal(a.indptr, c.indptr)

    def passages(x):
        return sorted((tuple(x.ids[p:q]), x.values[p:q].tobytes())
                      for p, q in zip(x.indptr[:-1], x.indptr[1:]))

    assert passages(a) == passages(c)


def test_reference_and_generator_load_without_the_program():
    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "import harness.sparse_corpus, harness.splade_queries\n"
        "import reference.splade_dot\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'diagon_tpu', 'diagon_tpu_torch'})\n"
        "print(bad); sys.exit(1 if bad else 0)\n" % str(BENCH)
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr[-2000:]


def test_adapter_copies_are_fresh_objects():
    """A fresh copy is a new object each call: the searcher's plan cache,
    keyed by identity, misses as for a client that parses anew."""
    v = to_vector(("bool", (), ("1^1", "2^2"), ()))
    assert copy.copy(v) is not v and System.fresh(v) is not System.fresh(v)


def test_light_ranges_lie_inside_route(tmp_path):
    """In ``QueryProfiler.trace``'s Chrome trace of a partitioned batch,
    with the phase profiler off: one ``plan`` range, then one ``route``
    range, and inside it a ``light`` range a group."""
    QueryProfiler._tls.profiler = QueryProfiler(enabled=False)
    corpus, system, _ = _tiny(SEEDS[1])
    _forced(system, 1)
    specs = _specs(dict(TINY, dev_queries=12))
    qs = System.queries(specs, "splade")
    before = registry.snapshot()
    with QueryProfiler.trace(str(tmp_path), device="cpu"):
        system.collect(system.dispatch(qs, K))
    groups = _delta(before, ("search.compact_groups",))["search.compact_groups"]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {"plan": [], "route": [], "light": []}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in spans:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    (plan,), (route,) = spans["plan"], spans["route"]
    assert groups > 1 and len(spans["light"]) == groups
    assert plan[1] <= route[0]
    assert all(route[0] <= a <= z <= route[1] for a, z in spans["light"])
