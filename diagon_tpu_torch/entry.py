"""The port's counterparts of ``__graft_entry__``'s ``entry()``, the
flagship scoring step and its arguments, and ``dryrun_multichip(n)``, the
serving step over n ranks (``dryrun_multichip`` below).

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
import torch


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


def _dryrun_queries():
    """``__graft_entry__.dryrun_multichip``'s queries: 5 through the
    exhaustive program (OR, AND, phrase, FILTER range + SHOULD, a nested
    tree), and those 5 plus 4 terms as a pruned batch of 9."""
    from diagon_tpu_torch.search.query import (
        BooleanQuery,
        NumericRangeQuery,
        Occur,
        PhraseQuery,
        TermQuery,
    )

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
    b4.add(queries[0], Occur.MUST)  # nested subtree
    b4.add(TermQuery("body", "trade"), Occur.SHOULD)
    queries.append(b4.build())
    pruned = list(queries) + [
        TermQuery("body", f"w{i}") for i in range(2, 2 + 4)
    ]
    return queries, pruned


def _dryrun_rank(n_devices: int, device):
    """One rank of ``dryrun_multichip``: every shard built, this rank's on
    its device, both batches searched and held against the oracle.
    Returns (exhaustive results, pruned results, kernel launches)."""
    from diagon_tpu_torch.ops import launches as launched
    from diagon_tpu_torch.parallel import ShardedSearcher
    from diagon_tpu_torch.search.oracle import OracleSearcher

    shards = [_tiny_corpus(40 + 10 * i, seed=100 + i)
              for i in range(n_devices)]
    kernels = ("row_boolean", "approx_select", "approx_select_bool",
               "approx_select_bool2", "gather_rescore", "union_rescore")
    before = {n: launched(n) for n in kernels}
    ss = ShardedSearcher(shards, "body", device=device)
    queries, pruned = _dryrun_queries()
    oracle = OracleSearcher(shards)
    results = []
    for batch, want_compact in ((queries, False), (pruned, True)):
        if (ss._plans(batch)[-1] is not None) != want_compact:
            raise AssertionError(
                f"a batch of {len(batch)} took the wrong program")
        got = ss.search_batch(batch, k=10)
        for q, td in zip(batch, got):
            want = oracle.search(q, 10)
            if (td.doc_ids() != want.doc_ids()
                    or td.total_hits != want.total_hits):
                raise AssertionError(f"{q!r}: sharded {td}, oracle {want}")
        results.append(got)
    launches = {n: launched(n) - before[n] for n in kernels}
    return results[0], results[1], launches


def dryrun_multichip(n_devices: int, device="cuda"):
    """The serving step over ``n_devices`` ranks, one segment shard each:
    the twin of ``__graft_entry__.dryrun_multichip``. The same shards
    (``_tiny_corpus(40 + 10*i, seed=100+i)``) and queries, every answer
    held against the oracle, over ``parallel.launch.run_ranks`` with gloo
    (collectives on host copies: the ranks may share one card, which NCCL
    refuses). On CUDA the kernels are built here, before the ranks start.
    Returns rank 0's (exhaustive, pruned) results, which every rank must
    equal, and each rank's kernel launches."""
    from diagon_tpu_torch.parallel.launch import run_ranks

    if torch.device(device).type == "cuda":
        from diagon_tpu_torch.ops import _build

        _build.library()
    ranks = run_ranks(_dryrun_rank, n_devices, "gloo", n_devices, device)
    ex0, pr0, _ = ranks[0]
    for r, (ex, pr, _) in enumerate(ranks):
        if ex != ex0 or pr != pr0:
            raise AssertionError(f"rank {r}'s results differ from rank 0's")
    n_docs = sum(40 + 10 * i for i in range(n_devices))
    print(
        f"dryrun_multichip({n_devices}): OK — {n_docs} docs across "
        f"{n_devices} shards, {len(ex0)} exhaustive + {len(pr0)} "
        "pruned-batch queries, top-10 matches oracle", flush=True,
    )
    return ex0, pr0, [launches for _, _, launches in ranks]
