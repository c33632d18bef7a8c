"""The port's storage tiers and tier-managed searcher against the JAX
package's: the four ``TierManager`` cases of
``tests/unit/test_storage_tiers.py`` on both managers with equal decisions,
``_estimate_device_bytes`` equal on the same segments, and the
tier-managed searcher case (3 x 400 docs, a budget of 2.5 segments) with
equal residency, bit-equal results against the JAX tier-managed searcher
and the oracle, ``MemoryError`` from ``dispatch_batch``, freed demoted
segments, and the stale-plan case (F3) where the JAX searcher fails."""

import gc
import time
import weakref

import numpy as np
import pytest

import diagon_tpu.observability.storage_tiers as jtiers
import diagon_tpu_torch.observability.storage_tiers as ttiers
from diagon_tpu.document import Document as JDocument
from diagon_tpu.document import TextField as JTextField
from diagon_tpu.index.memory_index import MemoryIndex as JMemoryIndex
from diagon_tpu.index.segment import flush_memory_index as jflush
from diagon_tpu.search import query as jq
from diagon_tpu.search.searcher import IndexSearcher as JSearcher
from diagon_tpu_torch.document import Document, TextField
from diagon_tpu_torch.index.memory_index import MemoryIndex
from diagon_tpu_torch.index.segment import flush_memory_index
from diagon_tpu_torch.observability.storage_tiers import StorageTier
from diagon_tpu_torch.search import query as tq
from diagon_tpu_torch.search.oracle import OracleSearcher
from diagon_tpu_torch.search.searcher import IndexSearcher

# ---------------------------------------------------------------------------
# the TierManager cases of tests/unit/test_storage_tiers.py, on both
# managers: each scenario returns its decisions, which must be equal
# ---------------------------------------------------------------------------


def _budget_eviction_lru(m):
    demoted = []
    tm = m.TierManager(hbm_budget_bytes=100, demote_to_host=demoted.append)
    tm.register("a", m.StorageTier.DEVICE, bytes_device=40)
    tm.register("b", m.StorageTier.DEVICE, bytes_device=40)
    tm.register("c", m.StorageTier.HOST, bytes_device=40)
    tm.touch("a")  # b becomes LRU
    evicted = tm.ensure_device("c")
    return {"evicted": evicted, "demoted": demoted,
            "tiers": {n: tm.tier_of(n).value for n in "abc"},
            "device_bytes": tm.device_bytes()}


def _pinned_never_evicted(m):
    tm = m.TierManager(hbm_budget_bytes=50)
    tm.register("pinned", m.StorageTier.DEVICE, bytes_device=40, pinned=True)
    tm.register("x", m.StorageTier.HOST, bytes_device=40)
    try:
        tm.ensure_device("x")
        raised = False
    except MemoryError:
        raised = True
    return {"raised": raised,
            "tiers": {n: tm.tier_of(n).value for n in ("pinned", "x")}}


def _lifecycle_demotion(m):
    tm = m.TierManager(
        hbm_budget_bytes=1000,
        policy=m.LifecyclePolicy(demote_to_host_after=0.0,
                                 demote_to_disk_after=0.0),
    )
    tm.register("old", m.StorageTier.DEVICE, bytes_device=10)
    tm._entries["old"].last_access -= 10
    first = {n: t.value for n, t in tm.apply_lifecycle().items()}
    tm._entries["old"].last_access -= 10
    second = {n: t.value for n, t in tm.apply_lifecycle().items()}
    return {"first": first, "second": second}


def _stats_and_touch(m):
    tm = m.TierManager(hbm_budget_bytes=10)
    tm.register("s", m.StorageTier.DEVICE, bytes_device=5)
    age0 = tm.stats()["s"]["age_s"]
    time.sleep(0.01)
    tm.touch("s")
    stats = tm.stats()["s"]
    return {"age_not_older": stats["age_s"] <= age0 + 0.01,
            "tier": stats["tier"], "bytes_device": stats["bytes_device"],
            "pinned": stats["pinned"]}


SCENARIOS = {
    "budget_eviction_lru": (_budget_eviction_lru, {
        "evicted": ["b"], "demoted": ["b"],
        "tiers": {"a": "device", "b": "host", "c": "device"},
        "device_bytes": 80}),
    "pinned_never_evicted": (_pinned_never_evicted, {
        "raised": True, "tiers": {"pinned": "device", "x": "host"}}),
    "lifecycle_demotion": (_lifecycle_demotion, {
        "first": {"old": "host"}, "second": {"old": "disk"}}),
    "stats_and_touch": (_stats_and_touch, {
        "age_not_older": True, "tier": "device", "bytes_device": 5,
        "pinned": False}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tier_manager_decides_as_the_jax_manager(name):
    scenario, want = SCENARIOS[name]
    got = scenario(ttiers)
    assert got == want
    assert got == scenario(jtiers)


# ---------------------------------------------------------------------------
# the tier-managed searcher (test_tier_managed_searcher_evicts_and_stays_
# exact), on the same three segments in both packages
# ---------------------------------------------------------------------------


def _texts():
    rng = np.random.Generator(np.random.PCG64(3))
    vocab = [f"w{i}" for i in range(30)] + ["oil", "price"]
    return [[" ".join(rng.choice(vocab, 20)) for _ in range(400)]
            for _ in range(3)]


@pytest.fixture(scope="module")
def segs():
    jsegs, tsegs = [], []
    for si, texts in enumerate(_texts()):
        jm, tm = JMemoryIndex(), MemoryIndex()
        for t in texts:
            jm.add_document(JDocument().add(JTextField("body", t)))
            tm.add_document(Document().add(TextField("body", t)))
        jsegs.append(jflush(jm, f"_t{si}"))
        tsegs.append(flush_memory_index(tm, f"_t{si}"))
    return jsegs, tsegs


def _queries(m):
    b = m.BooleanQuery.Builder()
    b.add(m.TermQuery("body", "oil"), m.Occur.SHOULD)
    b.add(m.TermQuery("body", "price"), m.Occur.SHOULD)
    nb = m.BooleanQuery.Builder()
    nb.add(m.TermQuery("body", "w3"), m.Occur.MUST)
    nb.add(m.TermQuery("body", "oil"), m.Occur.SHOULD)
    nb.add(m.TermQuery("body", "w7"), m.Occur.MUST_NOT)
    q1 = m.TermQuery("body", "oil")
    return {"term": q1, "or": b.build(), "must_not": nb.build(),
            "phrase": m.PhraseQuery("body", ["oil", "price"]),
            "match_all": m.MatchAllDocsQuery(), "term_again": q1}


def _same(got, want):
    assert got.total_hits == want.total_hits
    assert got.doc_ids() == want.doc_ids()
    gs = np.asarray([sd.score for sd in got.score_docs], np.float32)
    ws = np.asarray([sd.score for sd in want.score_docs], np.float32)
    assert np.array_equal(gs.view(np.uint32), ws.view(np.uint32))


def test_estimate_device_bytes_equals_the_jax_estimate(segs):
    jsegs, tsegs = segs
    for js, ts in zip(jsegs, tsegs):
        assert (IndexSearcher._estimate_device_bytes(ts)
                == JSearcher._estimate_device_bytes(js))


@pytest.fixture(scope="module")
def tiered(segs):
    jsegs, tsegs = segs
    est = JSearcher._estimate_device_bytes(jsegs[0])
    budget = int(est * 2.5)  # fits 2, not 3
    return (JSearcher(jsegs, hbm_budget_bytes=budget),
            IndexSearcher(tsegs, device="cpu", hbm_budget_bytes=budget),
            OracleSearcher(tsegs), est)


def _tiers(s):
    return {n: e["tier"] for n, e in s.tier_stats().items()}


def test_tier_stats_equal_the_jax_searcher(tiered):
    js, ts, _, _ = tiered
    assert _tiers(ts) == _tiers(js)
    tiers = list(_tiers(ts).values())
    assert tiers.count(StorageTier.DEVICE.value) == 2
    assert tiers.count(StorageTier.HOST.value) == 1
    assert sum(ds is None for ds in ts.device_segments) == 1


@pytest.mark.parametrize("name", list(_queries(tq)))
def test_tier_managed_search_equals_jax_and_oracle(tiered, name):
    js, ts, oracle, _ = tiered
    q, jquery = _queries(tq)[name], _queries(jq)[name]
    got = ts.search(q, 10)
    _same(got, oracle.search(q, 10))
    _same(got, js.search(jquery, 10))
    assert ts.count(q) == oracle.count(q) == js.count(jquery)
    assert _tiers(ts) == _tiers(js)


def test_search_batch_falls_back_to_search(tiered):
    js, ts, oracle, _ = tiered
    qs = [q for n, q in _queries(tq).items() if n not in ("phrase", "match_all")]
    jqs = [q for n, q in _queries(jq).items() if n not in ("phrase", "match_all")]
    for got, q, jres in zip(ts.search_batch(qs, 10), qs,
                            js.search_batch(jqs, 10)):
        _same(got, ts.search(q, 10))
        _same(got, jres)


def test_dispatch_batch_raises_memory_error(tiered):
    js, ts, _, _ = tiered
    with pytest.raises(MemoryError):
        js.dispatch_batch([_queries(jq)["term"]], 10)
    with pytest.raises(MemoryError):
        ts.dispatch_batch([_queries(tq)["term"]], 10)


@pytest.mark.parametrize("budget", ["host_tier", "resident"])
def test_search_batch_is_dispatch_then_collect_or_search(segs, tiered,
                                                         budget):
    """Where the budget leaves a segment HOST-tier, ``search_batch`` is
    per-query ``search`` (``dispatch_batch`` raises MemoryError); where
    every segment is resident, it is ``collect_batch`` of
    ``dispatch_batch``. The oracle's answers either way."""
    _, tsegs = segs
    _, ts, oracle, est = tiered
    if budget == "resident":
        ts = IndexSearcher(tsegs, device="cpu", hbm_budget_bytes=est * 10)
    qs = [q for n, q in _queries(tq).items() if n not in ("phrase", "match_all")]
    got = ts.search_batch(qs, 10)
    if budget == "host_tier":
        assert any(ds is None for ds in ts.device_segments)
        with pytest.raises(MemoryError):
            ts.dispatch_batch(qs, 10)
        want = [ts.search(q, 10) for q in qs]
    else:
        assert all(ds is not None for ds in ts.device_segments)
        want = ts.collect_batch(ts.dispatch_batch(qs, 10))
    assert got == want and repr(got) == repr(want)
    for g, q in zip(got, qs):
        _same(g, oracle.search(q, 10))


def test_a_generous_budget_makes_all_resident(segs, tiered):
    jsegs, tsegs = segs
    _, _, oracle, est = tiered
    s = IndexSearcher(tsegs, device="cpu", hbm_budget_bytes=est * 10)
    js = JSearcher(jsegs, hbm_budget_bytes=est * 10)
    assert all(t == "device" for t in _tiers(s).values())
    assert _tiers(s) == _tiers(js)
    qs = [_queries(tq)["or"], _queries(tq)["must_not"]]
    _same(s.search(qs[0], 10), oracle.search(qs[0], 10))
    h = s.dispatch_batch(qs, 10)
    for got, q in zip(s.collect_many([h])[0], qs):
        _same(got, oracle.search(q, 10))


def test_a_demoted_segment_is_freed(segs, tiered):
    """The demotion drops every holder of the segment's tensors: its
    DeviceSegment dies once the executors, the batch entries and the
    phrase executors that saw it are gone."""
    _, tsegs = segs
    _, _, _, est = tiered
    s = IndexSearcher(tsegs, device="cpu", hbm_budget_bytes=est * 10)
    qs = [_queries(tq)["or"], _queries(tq)["must_not"]]
    s.collect_many([s.dispatch_batch(qs, 10)])
    s.search(_queries(tq)["phrase"], 10)
    ds = s.device_segments[1]
    ex = s._ctx("body").row_executors[1]
    refs = [weakref.ref(ds), weakref.ref(ex), weakref.ref(ex.index),
            weakref.ref(ex.index.heavy_bank)]
    del ds, ex
    s._tier_demote(tsegs[1].name)
    gc.collect()
    assert [r() is None for r in refs] == [True] * len(refs)
    assert s._ctx("body").row_executors[1] is None
    assert s._phrase_execs == {}


@pytest.mark.parametrize("change", ["grown", "shrunk"])
def test_a_cached_plan_is_not_served_after_residency_changes(segs, tiered,
                                                            change):
    """F3: a plan cached under one residency, served after the budget
    changed. The JAX searcher serves the stale plan: it skips a segment
    promoted since (fewer hits than the oracle) or calls the executor of
    one demoted since (AttributeError). The port keys its plans by
    residency and gives the oracle's answer."""
    jsegs, tsegs = segs
    _, _, oracle, est = tiered
    budget = int(est * 2.5)
    after = est * 10 if change == "grown" else int(est * 1.5)
    jq_, q = _queries(jq)["term"], _queries(tq)["term"]
    js = JSearcher(jsegs, hbm_budget_bytes=budget)
    ts = IndexSearcher(tsegs, device="cpu", hbm_budget_bytes=budget)
    want = oracle.search(q, 10)
    _same(js.search(jq_, 10), want)
    _same(ts.search(q, 10), want)
    js._tier.hbm_budget = ts._tier.hbm_budget = after
    if change == "grown":
        assert js.search(jq_, 10).total_hits < want.total_hits
    else:
        with pytest.raises(AttributeError):
            js.search(jq_, 10)
    _same(ts.search(q, 10), want)
    assert ts.count(q) == oracle.count(q)
    assert _tiers(ts) == _tiers(js)


def test_the_searcher_docstring_no_longer_says_not_ported():
    assert "not ported" not in IndexSearcher.__doc__
    assert "hbm_budget_bytes" in IndexSearcher.__doc__


def test_validator_tool(tmp_path):
    """test_validator_tool of the JAX suite, on an index the port's API
    wrote (a delete included)."""
    import subprocess
    import sys
    from pathlib import Path

    import diagon_tpu_torch.api as dg

    root = Path(__file__).resolve().parents[1]
    path = str(tmp_path / "idx")
    w = dg.open_writer(path)
    for t in ["oil price up", "trade deal done", "oil supply cut"]:
        dg.add_document(w, {"body": t})
    dg.delete_documents(w, "body", "deal")
    dg.commit(w)
    dg.close_writer(w)
    r = subprocess.run(
        [sys.executable, "tools/validate_bundle.py", path, "--deep"],
        capture_output=True, text=True, cwd=root,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "RESULT: OK" in r.stdout
