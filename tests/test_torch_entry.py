"""The port's ``entry()`` twin (``diagon_tpu_torch.entry``) against
``__graft_entry__.entry()``: the same tiny corpus flushed into an equal
segment, and the same fused rows (top-k docids, score bits, hits) from the
port's row kernel (its plain version on the CPU) and the JAX step."""

import numpy as np
import pytest

import __graft_entry__ as graft
from diagon_tpu_torch import entry as twin

from test_torch_memory_index import assert_segments_equal


def test_tiny_corpus_equals_jax():
    assert_segments_equal(twin._tiny_corpus(400), graft._tiny_corpus(400))


@pytest.mark.parametrize("n_docs,seed", [(40, 100), (90, 103)])
def test_sharded_corpora_equal_jax(n_docs, seed):
    """The corpora of ``dryrun_multichip``'s shards too."""
    assert_segments_equal(twin._tiny_corpus(n_docs, seed),
                          graft._tiny_corpus(n_docs, seed))


def test_entry_step_equals_jax():
    fn, args = twin.entry(device="cpu")
    jfn, jargs = graft.entry()
    assert len(args) == len(jargs) == 10
    for i, (a, j) in enumerate(zip(args, jargs)):
        a, j = a.numpy(), np.asarray(j)
        if i == 1:
            # the light bank: the JAX package pads its rows to a bucket
            # (a TPU mechanism the port leaves out); the rows are equal
            assert (j[len(a):] == 0).all()
            j = j[:len(a)]
        np.testing.assert_array_equal(a, j)
    got = fn(*args).numpy()
    want = np.asarray(jfn(*jargs))
    assert got.shape == want.shape == (8, 21)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    hits = got[:, -1]
    assert (hits == hits[0]).all() and hits[0] > 0
    docs = got[0, 10:20]
    assert (docs >= 0).all()


def test_dryrun_multichip_equals_jax_sharded():
    """``dryrun_multichip(4)`` on 4 gloo ranks (the CPU) checks its 5
    exhaustive and 9 pruned-batch queries against the oracle; rank 0's
    answers equal the JAX ShardedSearcher's over
    ``__graft_entry__.dryrun_multichip``'s shards and queries on a 4-device
    mesh: the same docids, score bits and hits."""
    import jax
    from jax.sharding import Mesh

    from diagon_tpu.parallel.sharded import ShardedSearcher
    from diagon_tpu.search.query import (
        BooleanQuery,
        NumericRangeQuery,
        Occur,
        PhraseQuery,
        TermQuery,
    )

    ex, pruned, launches = twin.dryrun_multichip(4, device="cpu")
    assert len(launches) == 4 and len(ex) == 5 and len(pruned) == 9

    # __graft_entry__.dryrun_multichip's batches, built as it builds them
    queries = []
    b = BooleanQuery.Builder()
    for t in ["oil", "price", "w1", "w4"]:
        b.add(TermQuery("body", t), Occur.SHOULD)
    queries.append(b.build())
    b2 = BooleanQuery.Builder()
    b2.add(TermQuery("body", "oil"), Occur.MUST)
    b2.add(TermQuery("body", "price"), Occur.MUST)
    queries.append(b2.build())
    queries.append(PhraseQuery("body", ["oil", "price"]))
    b3 = BooleanQuery.Builder()
    b3.add(NumericRangeQuery("year", 1985, 1995), Occur.FILTER)
    b3.add(TermQuery("body", "oil"), Occur.SHOULD)
    queries.append(b3.build())
    b4 = BooleanQuery.Builder()
    b4.add(queries[0], Occur.MUST)
    b4.add(TermQuery("body", "trade"), Occur.SHOULD)
    queries.append(b4.build())
    pruned_qs = list(queries) + [TermQuery("body", f"w{i}") for i in range(2, 6)]
    mine, mine_pruned = twin._dryrun_queries()
    assert [repr(q) for q in mine_pruned] == [repr(q) for q in pruned_qs]
    assert [repr(q) for q in mine] == [repr(q) for q in queries]

    shards = [graft._tiny_corpus(40 + 10 * i, seed=100 + i) for i in range(4)]
    ss = ShardedSearcher(shards, "body",
                         mesh=Mesh(np.array(jax.devices()[:4]), ("seg",)))
    assert ss._plans(pruned_qs)[-1] is not None
    for got, want in zip(ex + pruned, ss.search_batch(queries, 10)
                         + ss.search_batch(pruned_qs, 10)):
        assert got.total_hits == want.total_hits
        assert got.doc_ids() == want.doc_ids()
        np.testing.assert_array_equal(
            np.asarray(got.scores(), np.float32).view(np.uint32),
            np.asarray(want.scores(), np.float32).view(np.uint32))
