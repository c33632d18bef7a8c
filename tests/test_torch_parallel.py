"""The port's segment-sharded searcher (``diagon_tpu_torch.parallel``)
against the JAX ``ShardedSearcher`` on a 4-device mesh and both packages'
oracles: the same docids, the same f32 score bits and the same total hits,
the same escalation counts and the same kernel choice per batch.

Four ranks run over gloo on the CPU (the wrappers' plain versions), spawned
once for the module by ``parallel.launch.run_ranks``; they import this
module, so its top level imports nothing of JAX or of the JAX package
(the fixtures import them in the parent), and the ranks check that none
was loaded. The cases mirror ``tests/unit/test_parallel.py``, plus the
merge's signed zeros and NaN, a batch whose route only the reduction over
all shards decides, the aligned heavy bank, one-rank groups and the error
cases.
"""

import copy
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from diagon_tpu_torch.parallel import ShardedSearcher, merge_topk
from diagon_tpu_torch.parallel.launch import run_ranks

K = 10
WORLD = 4
VOCAB = np.asarray(
    [f"w{i}" for i in range(80)] + ["oil", "price", "trade"], dtype=object
)
COMMONS = [f"c{i}" for i in range(10)]


# ---------------------------------------------------------------------------
# Shards: the JAX test's, built with the JAX package and carried across
# ---------------------------------------------------------------------------


def _texts(rng, n, vocab, mean_len=30):
    out = []
    for _ in range(n):
        ln = max(1, int(rng.normal(mean_len, 8)))
        out.append(" ".join(rng.choice(vocab, size=ln)))
    return out


def _flush(docs, name):
    from diagon_tpu.index.memory_index import MemoryIndex
    from diagon_tpu.index.segment import flush_memory_index

    mem = MemoryIndex()
    for d in docs:
        mem.add_document(d)
    return flush_memory_index(mem, name)


def _plain_shards(rng, sizes):
    """tests/unit/test_parallel.py's ``_build_shards``."""
    from diagon_tpu.document import Document, TextField

    return [_flush([Document().add(TextField("body", t))
                    for t in _texts(rng, n, VOCAB)], f"_s{i}")
            for i, n in enumerate(sizes)]


def _rich_shards(rng, sizes):
    """tests/unit/test_parallel.py's ``_build_rich_shards``: phrases, doc
    values and points."""
    from diagon_tpu.document import (
        Document,
        LongPointField,
        NumericDocValuesField,
        TextField,
    )

    shards = []
    gid = 0
    for i, n in enumerate(sizes):
        docs = []
        for t in _texts(rng, n, VOCAB):
            toks = t.split()
            if gid % 9 == 0 and len(toks) > 3:
                toks[1:3] = ["oil", "price"]
            doc = Document().add(TextField("body", " ".join(toks)))
            doc.add(TextField("title", " ".join(toks[:4])))
            doc.add(NumericDocValuesField("year", 1980 + gid % 25))
            doc.add(LongPointField("size", gid * 7 % 3000))
            docs.append(doc)
            gid += 1
        shards.append(_flush(docs, f"_r{i}"))
    return shards


def _route_shards():
    """Shards whose batches only the reduction over every shard routes as
    the JAX program does: c0-c9 and ``gamma`` are heavy by collection df
    (``gamma`` only in shard 0, so the others hold it as an absent row);
    the MUST term ``alpha`` is in shards 0 and 2 only, the light term
    ``beta`` in shards 0-2, so shard 3 has no light row."""
    from diagon_tpu.document import Document, TextField

    rng = np.random.Generator(np.random.PCG64(5))
    shards = []
    for si, n in enumerate([280, 300, 320, 340]):
        docs = []
        for _ in range(n):
            toks = list(rng.choice(COMMONS, 8))
            if si == 0:
                toks.append("gamma")
            if si in (0, 2) and rng.random() < 0.1:
                toks.append("alpha")
            if si in (0, 1, 2) and rng.random() < 0.1:
                toks.append("beta")
            docs.append(Document().add(TextField("body", " ".join(toks))))
        shards.append(_flush(docs, f"_g{si}"))
    return shards


def _deleted(shards):
    """tests/unit/test_parallel.py's deletes: the top 4 'oil' docs."""
    from diagon_tpu.search.oracle import OracleSearcher
    from diagon_tpu.search.query import TermQuery

    shards2 = [copy.deepcopy(s) for s in shards]
    td = OracleSearcher(shards2).search(TermQuery("body", "oil"), 6)
    bases = np.cumsum([0] + [s.num_docs for s in shards2])
    for gd in td.doc_ids()[:4]:
        si = int(np.searchsorted(bases, gd, side="right") - 1)
        shards2[si].delete_document(gd - int(bases[si]))
    return shards2


# ---------------------------------------------------------------------------
# Batches, built natively in either package (the query APIs are the same)
# ---------------------------------------------------------------------------


def _B(qm, *cl, ms=0):
    b = qm.BooleanQuery.Builder()
    for q, o in cl:
        b.add(q, o)
    b.set_minimum_number_should_match(ms)
    return b.build()


def _mixed(qm, n=12):
    """tests/unit/test_parallel.py's ``_mixed_batch``."""
    T, O = (lambda t: qm.TermQuery("body", t)), qm.Occur
    qs = [
        T("oil"),
        T("trade"),
        _B(qm, (T("oil"), O.SHOULD), (T("price"), O.SHOULD),
           (T("w3"), O.SHOULD)),
        _B(qm, (T("oil"), O.MUST), (T("price"), O.MUST)),
        _B(qm, (T("oil"), O.FILTER)),
        _B(qm, (qm.PointRangeQuery("size", 100, 1500), O.FILTER),
           (T("trade"), O.SHOULD)),
        _B(qm, (T("oil"), O.SHOULD), (T("price"), O.SHOULD),
           (T("trade"), O.SHOULD), ms=2),
        _B(qm, (T("trade"), O.SHOULD), (T("oil"), O.MUST_NOT)),
    ]
    i = 0
    while len(qs) < n:
        qs.append(T(f"w{i}"))
        i += 1
    return qs


def _batches(qm):
    """name -> queries, in the package whose query module is ``qm``."""
    T, O = (lambda t: qm.TermQuery("body", t)), qm.Occur
    sub = _B(qm, (T("oil"), O.SHOULD), (T("price"), O.SHOULD))
    or_batch = [T("oil"), T("price"), T("trade")] + [
        _B(qm, (T("oil"), O.SHOULD), (T(f"w{i}"), O.SHOULD))
        for i in range(9)
    ]
    bool_batch = [
        _B(qm, (T("oil"), O.MUST), (T("price"), O.MUST)),
        _B(qm, (T("trade"), O.FILTER), (T("oil"), O.SHOULD)),
        _B(qm, (T("oil"), O.MUST), (T("w1"), O.SHOULD), (T("w2"), O.SHOULD)),
    ] * 4
    route = [
        _B(qm, (T("alpha"), O.MUST), (T("c1"), O.SHOULD)),
        _B(qm, (T("beta"), O.SHOULD), (T("c2"), O.SHOULD)),
        _B(qm, (T("gamma"), O.SHOULD), (T("c3"), O.SHOULD)),
        _B(qm, (T("gamma"), O.MUST), (T("beta"), O.SHOULD)),
    ] + [_B(qm, (T(f"c{i}"), O.SHOULD), (T(f"c{(i + 3) % 10}"), O.SHOULD))
         for i in range(6)]
    return {
        "term": [T("oil")],
        "boolean": [
            _B(qm, *[(T(t), O.SHOULD) for t in ["oil", "price", "w3", "w10"]]),
            _B(qm, (T("oil"), O.MUST), (T("price"), O.MUST)),
            T("w1"),
        ],
        "min_should": [_B(qm, *[(T(t), O.SHOULD)
                                for t in ["oil", "price", "trade", "w5"]],
                          ms=2)],
        "phrase_range_nested": [
            qm.PhraseQuery("body", ["oil", "price"]),
            qm.NumericRangeQuery("year", 1985, 1995),
            qm.PointRangeQuery("size", 100, 1500),
            qm.MatchAllDocsQuery(),
            _B(qm, (qm.PhraseQuery("body", ["oil", "price"]), O.MUST),
               (T("trade"), O.SHOULD)),
            _B(qm, (qm.NumericRangeQuery("year", 1983, 1999), O.FILTER),
               (T("oil"), O.SHOULD)),
            _B(qm, (sub, O.MUST), (T("w3"), O.SHOULD)),
            _B(qm, (sub, O.SHOULD), (T("w7"), O.SHOULD)),
            _B(qm, (T("oil"), O.SHOULD), (qm.TermQuery("title", "w2"),
                                          O.SHOULD)),
            _B(qm, (T("trade"), O.SHOULD), (sub, O.MUST_NOT)),
        ],
        "mixed": _mixed(qm),
        "or": or_batch,
        "bool": bool_batch,
        "neg": bool_batch[:10] + [
            _B(qm, (T("oil"), O.SHOULD), (T("w3"), O.MUST_NOT))] * 2,
        "route": route,
        "route_exhaustive": [route[0], route[2], route[3]],
    }


# (shard set, batch, prune_B_override), in the order every rank runs them
JOBS = {
    "plain": [("term", 0), ("boolean", 0), ("min_should", 0)],
    "deleted": [("term", 0)],
    "rich": [("phrase_range_nested", 0), ("mixed", 0), ("mixed", 1),
             ("or", 0), ("bool", 0), ("neg", 0)],
    "route": [("route_exhaustive", 0), ("route", 0)],
}


def _serve(jobs):
    """Rank body: per shard set a ShardedSearcher on the default group
    (device cpu), each batch searched. Returns ({(set, batch, B override):
    (TopDocs list, escalation counter increase, (pure_or, fused2) or None)},
    the JAX modules loaded in this rank)."""
    sys.modules["jax"] = sys.modules["diagon_tpu"] = None
    from diagon_tpu_torch.observability.metrics import registry

    esc = registry.counter("search.sharded_escalations")
    out = {}
    for name, shards, batches in jobs:
        ss = ShardedSearcher(shards, "body", device="cpu")
        for bname, queries, override in batches:
            ss.prune_B_override = override
            before = esc.value()
            got = ss.search_batch(queries, K)
            compact = ss._plans(queries)[-1]  # cached: no collective
            out[(name, bname, override)] = (
                got, esc.value() - before,
                None if compact is None
                else (compact["pure_or"], compact["fused2"]),
            )
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "diagon_tpu")
                    and sys.modules[m] is not None)
    return out, loaded


@pytest.fixture(scope="module")
def runs():
    """Every job on 4 spawned ranks, on the JAX ShardedSearcher over a
    4-device mesh, and both oracles."""
    import jax
    from jax.sharding import Mesh

    import diagon_tpu.search.query as jq
    from diagon_tpu.observability.metrics import registry as jreg
    from diagon_tpu.parallel.sharded import ShardedSearcher as JaxSharded
    from diagon_tpu.search.oracle import OracleSearcher as JaxOracle
    from diagon_tpu_torch.search import query as pq
    from diagon_tpu_torch.search.convert import segment_from_jax
    from diagon_tpu_torch.search.oracle import OracleSearcher

    plain = _plain_shards(np.random.Generator(np.random.PCG64(7)),
                          [100, 130, 160, 190])
    jshards = {
        "plain": plain,
        "deleted": _deleted(plain),
        "rich": _rich_shards(np.random.Generator(np.random.PCG64(21)),
                             [90, 115, 140, 165]),
        "route": _route_shards(),
    }
    pshards = {n: [segment_from_jax(s) for s in ss]
               for n, ss in jshards.items()}
    pb, jb = _batches(pq), _batches(jq)
    jobs = [(n, pshards[n], [(b, pb[b], o) for b, o in todo])
            for n, todo in JOBS.items()]
    t0 = time.monotonic()
    ranks = run_ranks(_serve, WORLD, "gloo", jobs, timeout=300)
    rank_s = time.monotonic() - t0

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("seg",))
    out = {}
    for name, todo in JOBS.items():
        jss = JaxSharded(jshards[name], "body", mesh=mesh)
        po, jo = OracleSearcher(pshards[name]), JaxOracle(jshards[name])
        for bname, override in todo:
            jss.prune_B_override = override
            before = jreg.snapshot().get("search.sharded_escalations", 0)
            got = jss.search_batch(jb[bname], K)
            esc = jreg.snapshot().get("search.sharded_escalations", 0) - before
            compact = jss._plans(jb[bname])[-1]
            key = (name, bname, override)
            out[key] = {
                "ranks": [r[0][key] for r in ranks],
                "jax": (got, esc, None if compact is None
                        else (compact["pure_or"], compact["fused2"])),
                "oracle": [po.search(q, K) for q in pb[bname]],
                "jax_oracle": [jo.search(q, K) for q in jb[bname]],
            }
    return {"out": out, "loaded": [r[1] for r in ranks], "rank_s": rank_s,
            "pshards": pshards, "pb": pb}


def _same(got, want, what):
    assert got.total_hits == want.total_hits, what
    assert got.doc_ids() == want.doc_ids(), what
    sg = np.asarray(got.scores(), np.float32).view(np.uint32)
    sw = np.asarray(want.scores(), np.float32).view(np.uint32)
    np.testing.assert_array_equal(sg, sw, err_msg=str(what))


def _check(runs, name, bname, override=0):
    """Every rank's results equal the JAX sharded searcher's and both
    oracles', bit for bit; returns the case's record."""
    rec = runs["out"][(name, bname, override)]
    jax_got = rec["jax"][0]
    for r, (got, _, _) in enumerate(rec["ranks"]):
        assert len(got) == len(jax_got) == len(rec["oracle"])
        for i, td in enumerate(got):
            what = (name, bname, override, r, i)
            _same(td, jax_got[i], what)
            _same(td, rec["oracle"][i], what)
            _same(td, rec["jax_oracle"][i], what)
    return rec


# ---------------------------------------------------------------------------
# merge_topk
# ---------------------------------------------------------------------------


def test_merge_topk_ordering():
    from diagon_tpu.parallel.sharded import merge_topk as jax_merge

    scores = [[1.0, 2.0, 2.0, 0.5, 2.0]]
    docs = [[7, 9, 3, 1, 5]]
    s, d = merge_topk(torch.tensor(scores), torch.tensor(docs,
                                                         dtype=torch.int32), 4)
    np.testing.assert_array_equal(d[0].numpy(), [3, 5, 9, 7])
    np.testing.assert_array_equal(s[0].numpy(), [2.0, 2.0, 2.0, 1.0])
    js, jd = jax_merge(np.asarray(scores, np.float32),
                       np.asarray(docs, np.int32), 4)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


def test_merge_topk_signed_zeros_and_nan():
    """``lax.sort``'s order, not ``lax.top_k``'s: -0.0 ties +0.0 (the
    docid decides) and NaN goes last; the scores keep their bits."""
    from diagon_tpu.parallel.sharded import merge_topk as jax_merge

    scores = np.asarray([[0.0, -0.0, 1, -1, np.nan, 1]], np.float32)
    docs = np.asarray([[5, 1, 9, 2, 3, 4]], np.int32)
    s, d = merge_topk(torch.from_numpy(scores), torch.from_numpy(docs), 6)
    np.testing.assert_array_equal(d[0].numpy(), [4, 9, 1, 5, 2, 3])
    js, jd = jax_merge(scores, docs, 6)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert np.signbit(s[0, 2].item()) and not np.signbit(s[0, 3].item())


# ---------------------------------------------------------------------------
# tests/unit/test_parallel.py, case for case
# ---------------------------------------------------------------------------


def test_sharded_term_query(runs):
    _check(runs, "plain", "term")


def test_sharded_boolean_batch(runs):
    _check(runs, "plain", "boolean")


def test_sharded_respects_deletes(runs):
    rec = _check(runs, "deleted", "term")
    plain = runs["out"][("plain", "term", 0)]["ranks"][0][0][0]
    assert rec["ranks"][0][0][0].total_hits == plain.total_hits - 4


def test_sharded_min_should_match(runs):
    _check(runs, "plain", "min_should")


def test_sharded_phrase_range_nested(runs):
    _check(runs, "rich", "phrase_range_nested")


def test_sharded_pruned_batch_parity(runs):
    rec = _check(runs, "rich", "mixed")
    assert rec["jax"][2] is not None
    assert all(route == rec["jax"][2] for _, _, route in rec["ranks"])


def test_sharded_pruned_escalation(runs):
    """B = 1 forces certificate failures; every rank's counter gains the
    JAX controller's increase, and the results stay exact."""
    rec = _check(runs, "rich", "mixed", 1)
    want = rec["jax"][1]
    assert want > 0
    assert [esc for _, esc, _ in rec["ranks"]] == [want] * WORLD


@pytest.mark.parametrize("bname,want", [("or", (True, False)),
                                        ("bool", (False, True)),
                                        ("neg", (False, False))])
def test_sharded_pruned_kernel_variants(runs, bname, want):
    rec = _check(runs, "rich", bname)
    assert rec["jax"][2] == want
    assert [route for _, _, route in rec["ranks"]] == [want] * WORLD


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bname,want", [("route_exhaustive", None),
                                        ("route", (False, True))])
def test_every_rank_takes_the_batch_route(runs, bname, want):
    """Shard 1 lacks the MUST term and shard 3 every light row: planned
    alone, they would take the pure-OR kernel and fewer compact rows (and
    match ``alpha``-less docs as pure ORs). The reduction gives every rank
    the JAX program's route over all shards, and the results are exact."""
    rec = _check(runs, "route", bname)
    assert rec["jax"][2] == want
    assert [route for _, _, route in rec["ranks"]] == [want] * WORLD
    assert rec["ranks"][0][0][0].total_hits > 0


def test_the_ranks_load_nothing_of_jax(runs):
    assert runs["loaded"] == [[]] * WORLD


def test_aligned_heavy_bank_equals_jax():
    """``build_heavy_bank(heavy_tids=...)``: row j holds tid j of the list;
    absent (-1) terms get a zero row, weight 0.0 and no term maps to them;
    the bank is resident even where the segment size would put it on
    demand."""
    from diagon_tpu.search.engine import make_tf_table
    from diagon_tpu.search.row_engine import RowFieldIndex as JaxRowIndex
    from diagon_tpu_torch.search.convert import segment_from_jax
    from diagon_tpu_torch.search.row_engine import RowFieldIndex

    jseg = _route_shards()[1]  # lacks gamma and alpha
    pseg = segment_from_jax(jseg)
    jpp, pfd = jseg.fields["body"].postings, pseg.fields["body"]
    names = ["c0", "gamma", "beta", "c7", "alpha", "c3"]
    tids = [jpp.term_id(t) for t in names]
    assert tids[1] == tids[4] == -1 and min(tids[:1] + tids[2:4]) >= 0
    lut = make_tf_table(np.float32(9.0), 8)

    def idf(tid):
        return np.float32(1.0 + tid / 7.0)

    jr = JaxRowIndex(jpp, jseg.fields["body"].norms, 1024, None, lut)
    jr.ON_DEMAND_MIN_DOCS = 1024
    jr.build_heavy_bank(idf, heavy_tids=tids)
    pr = RowFieldIndex(pfd.postings, pfd.norms, 1024, None, lut, "cpu")
    pr.ON_DEMAND_MIN_DOCS = 1024
    pr.build_heavy_bank(idf, heavy_tids=tids)
    assert not pr.bank_on_demand and not jr.bank_on_demand
    np.testing.assert_array_equal(pr.heavy_row_of_term, jr.heavy_row_of_term)
    np.testing.assert_array_equal(pr.heavy_tid_of_row, jr.heavy_tid_of_row)
    np.testing.assert_array_equal(pr.heavy_weight.view(np.uint32),
                                  jr.heavy_weight.view(np.uint32))
    assert pr.heavy_weight[1] == pr.heavy_weight[4] == 0.0
    bank = pr.heavy_bank.numpy()
    assert bank.shape == (len(tids), 1024)
    np.testing.assert_array_equal(
        bank.view(np.uint32),
        np.asarray(jr.heavy_bank)[: len(tids)].view(np.uint32))
    assert not bank[1].any() and not bank[4].any() and bank[0].any()


@pytest.fixture
def solo_group(tmp_path, monkeypatch):
    """A one-rank gloo group in this process."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("bname", ["phrase_range_nested", "mixed"])
def test_one_rank_group_equals_index_searcher(runs, solo_group, bname):
    from diagon_tpu_torch.search import IndexSearcher

    seg = runs["pshards"]["rich"][0]
    queries = runs["pb"][bname]
    ss = ShardedSearcher([seg], "body", device="cpu")
    assert (ss._plans(queries)[-1] is None) == (len(queries) < 8)
    want = IndexSearcher([seg], device="cpu").search_batch(queries, K)
    for i, (got, w) in enumerate(zip(ss.search_batch(queries, K), want)):
        _same(got, w, (bname, i))


def test_group_size_must_equal_the_shard_count(runs, solo_group):
    segs = runs["pshards"]["plain"][:2]
    with pytest.raises(ValueError, match="1 ranks, need 2"):
        ShardedSearcher(segs, "body", device="cpu")


def test_an_nccl_group_refuses_a_cpu_device(runs, solo_group, monkeypatch):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="NCCL"):
        ShardedSearcher(runs["pshards"]["plain"][:1], "body", device="cpu")


def test_no_cuda_and_no_device_raises(runs, solo_group, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedSearcher(runs["pshards"]["plain"][:1], "body")


def test_no_process_group_raises(runs):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        ShardedSearcher(runs["pshards"]["plain"][:1], "body", device="cpu")


def _fail_on_rank_1():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 gives up")
    dist.barrier()  # without rank 1, rank 0 waits here until its timeout


def test_a_failing_rank_fails_the_call():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        run_ranks(_fail_on_rank_1, 2, "gloo", timeout=300)
    assert time.monotonic() - t0 < 120
