"""The system under test for a sparse configuration: the port's
``SparseIndex`` built from the corpus's CSR by ``SparseIndex.from_csr``,
served by its ``SparseSearcher`` on the batch path (``dispatch_batch``,
then ``collect_batch``). The only module of a sparse configuration that
imports the program.

A query spec is a SHOULD list of ``"<id>^<weight>"`` clauses, Lucene's
boost syntax for a weighted term; the weight is read as
``np.float32(float(text))``."""

from __future__ import annotations

from typing import List

import numpy as np

from diagon_tpu_torch.sparse import SparseIndex, SparseSearcher, SparseVector

from harness import system as text
from harness.check import Answer


def to_vector(spec) -> SparseVector:
    """A ``("bool", (), should, ())`` spec of ``id^weight`` clauses."""
    kind, must, should, must_not = spec
    if kind != "bool" or must or must_not:
        raise ValueError(f"a sparse query is a SHOULD list: {spec!r}")
    ids, weights = [], []
    for clause in should:
        term, weight = clause.split("^")
        ids.append(int(term))
        weights.append(np.float32(float(weight)))
    return SparseVector(np.asarray(ids, np.int32),
                        np.asarray(weights, np.float32))


class System(text.System):
    """One searcher over one shard, fresh query objects every call (the
    text adapter's ``fresh``): the searcher's plan cache, keyed by object
    identity, never sees a query twice, as with a client that parses each
    request anew. ``dispatch``, ``counters`` and the phase profiler are the
    text adapter's."""

    def __init__(self, corpus, device):
        self.index = SparseIndex.from_csr(corpus.indptr, corpus.ids,
                                          corpus.values)
        self.searcher = SparseSearcher(self.index, device)

    @staticmethod
    def queries(specs, field: str) -> List[SparseVector]:
        return [to_vector(s) for s in specs]

    @staticmethod
    def answer(res) -> Answer:
        """A ``(scores, doc ids, hits)`` result as (hits, doc ids, scores)."""
        scores, docs, hits = res
        return (int(hits), tuple(int(d) for d in docs),
                tuple(float(s) for s in scores))

    def collect(self, handle) -> List:
        return self.searcher.collect_batch(handle)

    def close(self) -> None:
        self.index = None
        super().close()
