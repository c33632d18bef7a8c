"""Vectorized synthetic-corpus segment builder: the port's own copy of
``diagon_tpu/bench/bulk_build.py``.

Scale corpora are synthetic, so their build is columnar end to end: host
C++ (``csrc/host/bulk.cpp``, loaded by ``diagon_tpu_torch.native``) samples
the whole token-id stream (alias-method Zipf categorical, lognormal
lengths, phrase injection), a counting sort inverts it into CSR postings,
and the CSR feeds the block packer. The same seed gives the JAX package's
segment, posting for posting (``tests/test_torch_host_tier.py``).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from diagon_tpu_torch import native
from diagon_tpu_torch.bench.queries import PHRASES
from diagon_tpu_torch.bench.synthetic import REUTERS_DOC_COUNT, _build_vocab
from diagon_tpu_torch.codecs.postings import (
    PackedPostings,
    build_packed_postings_csr,
)
from diagon_tpu_torch.index.segment import SegmentData, SegmentFieldData


def _noop_log(*a) -> None:  # pragma: no cover
    pass


def _norms_from_lengths(lengths: np.ndarray, num_docs: int) -> np.ndarray:
    """Reference norm encoding: min(127, trunc(127/sqrt(len))) uint8
    (matches MemoryIndex.compute_norms; 0 for docs without the field)."""
    norms = np.zeros(num_docs, dtype=np.uint8)
    nz = lengths > 0
    norms[nz] = np.minimum(
        127.0, 127.0 / np.sqrt(lengths[nz].astype(np.float64))
    ).astype(np.uint8)
    return norms


def _pack_inverted(
    terms_sorted: List[str],
    entry_start: np.ndarray,
    docs: np.ndarray,
    freqs: np.ndarray,
    positions: Optional[np.ndarray],
    norms: np.ndarray,
    num_docs: int,
) -> PackedPostings:
    """CSR (dense vocab, possibly with zero-df terms) -> PackedPostings."""
    df = np.diff(entry_start)
    keep = df > 0
    if not keep.all():
        # drop zero-df terms: their CSR regions are empty, so the entry
        # arrays are untouched — only the term dict and offsets shrink
        terms_sorted = [t for t, k in zip(terms_sorted, keep) if k]
        entry_start = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(df[keep], dtype=np.int64)]
        )
    pos_start = None
    if positions is not None:
        pos_start = np.zeros(len(freqs) + 1, dtype=np.int64)
        np.cumsum(freqs, dtype=np.int64, out=pos_start[1:])
    pp = build_packed_postings_csr(
        terms_sorted, entry_start, docs, freqs, pos_start, positions, norms
    )
    pp.doc_count_with_field = int((norms > 0).sum())
    return pp


def _synth_field(
    num_docs: int,
    seed: int,
    probs: np.ndarray,
    len_kind: int,
    len_a: float,
    len_b: float,
    min_len: int,
    phrase_rank_ids: List[List[int]],
    phrase_prob: float,
    remap: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample one field's token-id stream -> (doc_len i32[N], tokens i32)."""
    if phrase_rank_ids:
        pflat = np.concatenate(
            [np.asarray(p, dtype=np.int32) for p in phrase_rank_ids]
        )
        pstart = np.zeros(len(phrase_rank_ids) + 1, dtype=np.int32)
        np.cumsum([len(p) for p in phrase_rank_ids], out=pstart[1:])
    else:
        pflat = np.zeros(0, dtype=np.int32)
        pstart = np.zeros(1, dtype=np.int32)
    return native.synth_tokens(
        num_docs, seed, probs, len_kind, float(len_a), float(len_b), min_len,
        pflat, pstart, float(phrase_prob), remap,
    )


def _invert_and_pack(
    terms_sorted: List[str],
    doc_len: np.ndarray,
    tokens: np.ndarray,
    vocab_size: int,
    num_docs: int,
    with_positions: bool,
) -> Tuple[PackedPostings, np.ndarray]:
    entry_start, docs, freqs, positions = native.invert_tokens(
        doc_len, tokens, vocab_size, with_positions
    )
    norms = _norms_from_lengths(doc_len.astype(np.int64), num_docs)
    pp = _pack_inverted(
        terms_sorted, entry_start, docs, freqs, positions, norms, num_docs
    )
    return pp, norms


def _date_field(num_docs: int) -> Tuple[PackedPostings, np.ndarray]:
    """The synthetic corpus's ``date`` StringField (keyword, 420 uniques):
    ``{(d%28)+1:02d}-FEB-1987 15:01:{d%60:02d}.00`` — zero-padded, so
    lexicographic term order == numeric (day, sec) order."""
    d = np.arange(num_docs, dtype=np.int64)
    code = (d % 28) * 60 + (d % 60)
    uniq, inv = np.unique(code, return_inverse=True)
    terms = [
        f"{int(c) // 60 + 1:02d}-FEB-1987 15:01:{int(c) % 60:02d}.00"
        for c in uniq
    ]
    order = np.argsort(inv, kind="stable")
    docs = order.astype(np.int32)
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.int64)
    entry_start = np.zeros(len(uniq) + 1, dtype=np.int64)
    np.cumsum(counts, out=entry_start[1:])
    freqs = np.ones(num_docs, dtype=np.int32)
    norms = np.full(num_docs, 127, dtype=np.uint8)  # field length 1
    pp = build_packed_postings_csr(
        terms, entry_start, docs, freqs, norms=norms
    )
    pp.doc_count_with_field = num_docs
    return pp, norms


def build_synthetic_segment(
    num_docs: int = REUTERS_DOC_COUNT,
    vocab_size: int = 30000,
    mean_len: float = 130.0,
    seed: int = 20260816,
    log: Callable = _noop_log,
) -> SegmentData:
    """Build the Reuters-shaped benchmark segment without materializing
    documents: title/body TextFields (positions) + date StringField,
    identical in distribution to ``synthetic.corpus_documents``."""
    vocab = _build_vocab(vocab_size)
    ranks = np.arange(vocab_size, dtype=np.float64)
    probs = 1.0 / np.power(ranks + 2.7, 1.07)
    probs /= probs.sum()

    # token ids come out of the sampler remapped into sorted-term space so
    # the counting sort directly yields dict-order CSR postings
    sort_order = sorted(range(vocab_size), key=vocab.__getitem__)
    terms_sorted = [vocab[i] for i in sort_order]
    remap = np.empty(vocab_size, dtype=np.int32)
    remap[np.asarray(sort_order, dtype=np.int64)] = np.arange(
        vocab_size, dtype=np.int32
    )
    word_rank = {w: i for i, w in enumerate(vocab)}
    phrase_rank_ids = [[word_rank[w] for w in p] for p in PHRASES]

    seg = SegmentData(name="_bench", num_docs=num_docs)

    t0 = time.time()
    dl, toks = _synth_field(
        num_docs, seed, probs, 0, np.log(mean_len), 0.7, 5,
        phrase_rank_ids, 0.08, remap,
    )
    log(f"body sampled: {len(toks) / 1e6:.0f}M tokens "
        f"({time.time() - t0:.0f}s)")
    t0 = time.time()
    pp, norms = _invert_and_pack(
        terms_sorted, dl, toks, vocab_size, num_docs, True
    )
    del toks
    seg.fields["body"] = SegmentFieldData(
        postings=pp, norms=norms, with_positions=True
    )
    log(f"body inverted+packed: {pp.num_terms} terms, "
        f"{pp.sum_doc_freq / 1e6:.0f}M entries ({time.time() - t0:.0f}s)")

    t0 = time.time()
    dl, toks = _synth_field(
        num_docs, seed + 1, probs, 1, 3.0, 9.0, 3, [], 0.0, remap
    )
    pp, norms = _invert_and_pack(
        terms_sorted, dl, toks, vocab_size, num_docs, True
    )
    del toks
    seg.fields["title"] = SegmentFieldData(
        postings=pp, norms=norms, with_positions=True
    )
    log(f"title inverted+packed ({time.time() - t0:.0f}s)")

    t0 = time.time()
    pp, norms = _date_field(num_docs)
    seg.fields["date"] = SegmentFieldData(
        postings=pp, norms=norms, with_positions=False
    )
    log(f"date field packed ({time.time() - t0:.0f}s)")
    return seg
