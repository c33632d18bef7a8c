"""``top_docs_batch`` against the per-query path it replaces on the batch
paths (one ``_to_topdocs``-style list a (query, segment), then
``merge_top_docs``), on seeded arrays shaped as ``RowExecutor.finalize``
returns them: equal TopDocs, Python ``int`` docids and ``float`` scores,
and ScoreDocs that compare and hash as the JAX package's."""

import dataclasses

import numpy as np
import pytest

from diagon_tpu.search.topdocs import ScoreDoc as JaxScoreDoc
from diagon_tpu_torch.observability.metrics import registry
from diagon_tpu_torch.search.topdocs import (ScoreDoc, TopDocs, merge_top_docs,
                                             top_docs_batch)

K = 10
SEG_DOCS = 50  # docs a segment; part p's doc base is p * SEG_DOCS

# Q queries, kk columns a part, P parts; ``levels``: scores drawn from that
# many values (ties within and across parts); ``pad``: share of entries
# padded (negative scores, -inf and NaN among them); ``zeros``: share set
# to +0.0 or -0.0; ``hits``: the hit counts drawn from (else each row's
# count of non-negative entries plus up to 100).
CASES = {
    "one_part": dict(Q=64, kk=K, P=1),
    "four_parts": dict(Q=64, kk=K, P=4),
    "ties": dict(Q=64, kk=K, P=4, levels=3),
    "padding_and_signed_zeros": dict(Q=64, kk=K, P=2, pad=0.4, zeros=0.2),
    "hits_zero_below_and_above_k": dict(Q=64, kk=K, P=2, hits=(0, 3, 10_000)),
    "kk_below_k": dict(Q=64, kk=4, P=3),
    "one_query": dict(Q=1, kk=K, P=2),
    "no_query": dict(Q=0, kk=K, P=2),
}


def _parts(seed, Q, kk, P, levels=0, pad=0.0, zeros=0.0, hits=None):
    rng = np.random.Generator(np.random.PCG64(seed))
    parts = []
    for p in range(P):
        if levels:
            scores = rng.choice(np.float32([0.5, 1.0, 1.5][:levels]), (Q, kk))
        else:
            scores = rng.random((Q, kk), dtype=np.float32) * 8
        z = rng.random((Q, kk)) < zeros
        scores[z] = rng.choice(np.float32([0.0, -0.0]), int(z.sum()))
        m = rng.random((Q, kk)) < pad
        scores[m] = rng.choice(np.float32([-1.0, -np.inf, np.nan]),
                               int(m.sum()))
        docs = rng.random((Q, SEG_DOCS)).argsort(axis=1)[:, :kk]
        if hits is None:
            h = (scores >= 0.0).sum(axis=1) + rng.integers(0, 100, Q)
        else:
            h = rng.choice(hits, Q)
        parts.append((scores, docs.astype(np.int32), h.astype(np.int32),
                      p * SEG_DOCS))
    return parts


def _per_query(parts, k):
    """The per-query path: ``IndexSearcher._to_topdocs`` a (query, part),
    then ``merge_top_docs``."""
    out = []
    for qi in range(parts[0][0].shape[0]):
        tds = []
        for scores, docs, hits, base in parts:
            n = int(hits[qi])
            sds = [ScoreDoc(int(d) + base, float(s))
                   for s, d in zip(np.asarray(scores[qi]),
                                   np.asarray(docs[qi]))
                   if s >= 0.0][:n]
            tds.append(TopDocs(n, sds))
        out.append(merge_top_docs(tds, k))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_top_docs_batch_equals_per_query_merge(name):
    parts = _parts(sum(map(ord, name)), **CASES[name])
    counter = registry.counter("search.topdocs_batched")
    before = counter.value()
    got = top_docs_batch(parts, K)
    assert counter.value() - before == len(got)
    want = _per_query(parts, K)
    assert got == want
    assert repr(got) == repr(want)  # -0.0 and +0.0 kept apart
    for td in got:
        assert type(td) is TopDocs and type(td.total_hits) is int
        assert type(td.score_docs) is list
        for sd in td.score_docs:
            assert type(sd) is ScoreDoc
            assert type(sd.doc) is int and type(sd.score) is float
            plain = ScoreDoc(sd.doc, sd.score)
            assert sd == plain and hash(sd) == hash(plain)
            # the JAX package's ScoreDoc: same hash and repr
            ref = JaxScoreDoc(sd.doc, sd.score)
            assert hash(sd) == hash(ref) and repr(sd) == repr(ref)
            assert sd != (sd.doc, sd.score)
            with pytest.raises(dataclasses.FrozenInstanceError):
                sd.doc = 0
    assert [f.name for f in dataclasses.fields(ScoreDoc)] == ["doc", "score"]
