"""The port's host oracle (``diagon_tpu_torch.search.oracle``) and its
vectorised block decode against the JAX package's: every term's blocks
decoded by ``decode_blocks_numpy`` equal to the JAX per-block decoder, and
``OracleSearcher.search`` equal to the JAX oracle (same docids, f32 score
bits and total hits) on phrases of one to three terms (repeated terms,
missing terms), booleans around them, ties past the last hit, deletes and
several segments. Segments are built with the JAX package and carried
into the port by ``convert``."""

import numpy as np
import pytest

from diagon_tpu.codecs.postings import decode_all_numpy as jax_decode_all
from diagon_tpu.codecs.postings import decode_block_numpy as jax_decode_block
from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search.oracle import OracleSearcher as JaxOracle
from diagon_tpu.search.query import (
    BooleanClause,
    BooleanQuery,
    Occur,
    PhraseQuery,
    TermQuery,
)
from diagon_tpu_torch.codecs.postings import decode_blocks_numpy
from diagon_tpu_torch.search.convert import query_from_jax, segment_from_jax
from diagon_tpu_torch.search.oracle import OracleSearcher

VOCAB = np.asarray([f"w{i}" for i in range(13)] + ["oil", "price", "rate"],
                   dtype=object)


def _segments():
    """Three JAX segments of seeded texts over a small vocabulary (terms
    span several 128-doc blocks and repeat within a doc), the middle one
    with deletes."""
    rng = np.random.Generator(np.random.PCG64(17))
    segs = []
    for i, n in enumerate((300, 520, 90)):
        mem = MemoryIndex()
        for _ in range(n):
            words = rng.choice(VOCAB, size=int(rng.integers(1, 60)))
            mem.add_document(Document().add(TextField("body", " ".join(words))))
        segs.append(flush_memory_index(mem, f"_{i}"))
    segs[1].live_docs = rng.random(segs[1].num_docs) > 0.2
    return segs


@pytest.fixture(scope="module")
def both():
    segs = _segments()
    return segs, [segment_from_jax(s) for s in segs]


def test_decode_blocks_equals_the_per_block_decoder(both):
    jsegs, psegs = both
    for js, ps in zip(jsegs, psegs):
        jpp, pp = js.fields["body"].postings, ps.fields["body"].postings
        for tid in range(len(pp.terms)):
            b0, b1 = int(pp.block_start[tid]), int(pp.block_start[tid + 1])
            parts = [jax_decode_block(jpp, b) for b in range(b0, b1)]
            docs, freqs = decode_blocks_numpy(pp, b0, b1)
            np.testing.assert_array_equal(
                docs, np.concatenate([d for d, _ in parts]))
            np.testing.assert_array_equal(
                freqs, np.concatenate([f for _, f in parts]))
        whole = decode_blocks_numpy(pp, 0, pp.num_blocks)
        for got, want in zip(whole, jax_decode_all(jpp)):
            np.testing.assert_array_equal(got, want)
    empty = decode_blocks_numpy(pp, 3, 3)
    assert [len(a) for a in empty] == [0, 0]


def _phrase(*terms):
    return PhraseQuery("body", list(terms))


QUERIES = {
    "one term": _phrase("oil"),
    "two terms": _phrase("oil", "price"),
    "three terms": _phrase("w1", "oil", "w2"),
    "repeated term": _phrase("w3", "w3"),
    "missing term": _phrase("oil", "nosuchterm"),
    "phrase MUST + term SHOULD": BooleanQuery([
        BooleanClause(_phrase("oil", "price"), Occur.MUST),
        BooleanClause(TermQuery("body", "rate"), Occur.SHOULD)]),
    "phrase SHOULD, MUST_NOT": BooleanQuery([
        BooleanClause(_phrase("w5", "w6"), Occur.SHOULD),
        BooleanClause(TermQuery("body", "w7"), Occur.SHOULD),
        BooleanClause(TermQuery("body", "oil"), Occur.MUST_NOT)]),
    "or of three terms": BooleanQuery([
        BooleanClause(TermQuery("body", t), Occur.SHOULD)
        for t in ("w0", "w9", "price")]),
}


@pytest.mark.parametrize("k", [10, 5000])
@pytest.mark.parametrize("name", list(QUERIES))
def test_search_equals_the_jax_oracle(both, name, k):
    jsegs, psegs = both
    q = QUERIES[name]
    want = JaxOracle(jsegs).search(q, k)
    got = OracleSearcher(psegs).search(query_from_jax(q), k)
    assert got.total_hits == want.total_hits
    assert got.doc_ids() == want.doc_ids()
    np.testing.assert_array_equal(
        np.float32(got.scores()).view(np.uint32),
        np.float32(want.scores()).view(np.uint32))
    if name != "missing term":
        assert got.total_hits > 0
