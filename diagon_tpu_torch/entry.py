"""The port's counterpart of ``__graft_entry__.entry()``: the flagship
scoring step and its arguments.

``_tiny_corpus`` builds the same 400-document corpus as
``__graft_entry__._tiny_corpus`` (the same seed and the same draws),
through the port's ``MemoryIndex`` and ``flush_memory_index``. ``entry``
returns the port's exhaustive boolean row kernel (``row_score_topk_pallas``:
kernel B2 on a CUDA device, its plain PyTorch version on the CPU) and its
arguments for the JAX ``entry()``'s boolean query, as a batch of 8 identical
plans. Calling ``fn(*args)`` gives the fused ``[8, 2k+1]`` rows: k scores,
k docids and the hit count.
"""

from __future__ import annotations

from functools import partial

import numpy as np


def _tiny_corpus(n_docs: int, seed: int = 7):
    from diagon_tpu_torch.document import (
        Document,
        NumericDocValuesField,
        TextField,
    )
    from diagon_tpu_torch.index.memory_index import MemoryIndex
    from diagon_tpu_torch.index.segment import flush_memory_index

    rng = np.random.Generator(np.random.PCG64(seed))
    vocab = np.asarray(
        [f"w{i}" for i in range(50)] + ["oil", "price", "trade"], dtype=object
    )
    mem = MemoryIndex()
    for i in range(n_docs):
        ln = max(3, int(rng.normal(25, 6)))
        toks = list(rng.choice(vocab, ln))
        if i % 5 == 0:
            toks[0:2] = ["oil", "price"]  # phrase hits
        doc = Document().add(TextField("body", " ".join(toks)))
        doc.add(NumericDocValuesField("year", 1980 + i % 20))
        mem.add_document(doc)
    return flush_memory_index(mem, "_entry")


def entry(device="cuda"):
    """(forward step, example args) on the flagship scoring model: the
    row-bank boolean scoring kernel over the 400-doc tiny corpus, for
    ``oil`` MUST and ``price``, ``trade``, ``w1``, ``w2`` SHOULD."""
    from diagon_tpu_torch.search.query import BooleanQuery, Occur, TermQuery
    from diagon_tpu_torch.search.row_engine import row_score_topk_pallas
    from diagon_tpu_torch.search.searcher import IndexSearcher

    searcher = IndexSearcher([_tiny_corpus(400)], device=device)
    b = BooleanQuery.Builder()
    b.add(TermQuery("body", "oil"), Occur.MUST)
    for t in ["price", "trade", "w1", "w2"]:
        b.add(TermQuery("body", t), Occur.SHOULD)
    field, clauses, min_should = searcher._term_clauses(b.build())
    plans = searcher._row_plans(field, clauses, min_should)
    ex = searcher._ctx(field).row_executors[0]
    # a batch of 8 identical plans (the general boolean kernel)
    return partial(row_score_topk_pallas, k=10), ex._args([plans[0]] * 8)
