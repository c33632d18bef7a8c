"""Deterministic Reuters-like synthetic corpus: the port's own copy of
``diagon_tpu/bench/synthetic.py``.

The corpus has 19,043 documents by default (the count the reference
indexes), a Zipf-distributed vocabulary of ~30k terms with the reference
benchmark's query terms planted at high-frequency ranks, log-normal body
lengths and injected phrase bigrams. ``_build_vocab`` feeds the segment
builder (``bench/bulk_build.py``); ``generate_reuters_like`` and
``corpus_documents`` give the same documents as the JAX package for the
same seed (numpy's PCG64), which the write path indexes.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from diagon_tpu_torch.bench.queries import OR_50, PHRASES

REUTERS_DOC_COUNT = 19043


def _build_vocab(vocab_size: int) -> List[str]:
    """Vocabulary with the benchmark terms planted in the head."""
    planted = list(dict.fromkeys(OR_50 + [t for p in PHRASES for t in p]))
    vocab = []
    seen = set()
    # Interleave planted terms through the head ranks (every 3rd rank) so
    # their collection frequencies spread like real Reuters economics terms.
    pi = 0
    gi = 0
    while len(vocab) < vocab_size:
        rank = len(vocab)
        if pi < len(planted) and rank % 3 == 1:
            w = planted[pi]
            pi += 1
        else:
            w = f"w{gi}"
            gi += 1
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    # Make sure all planted terms are present even for tiny vocab sizes.
    for w in planted:
        if w not in seen:
            vocab[-(planted.index(w) + 1)] = w
    return vocab


def generate_reuters_like(
    num_docs: int = REUTERS_DOC_COUNT,
    vocab_size: int = 30000,
    mean_len: float = 130.0,
    seed: int = 20260816,
) -> Iterator[Tuple[str, str, str]]:
    """Yield (date, title, body) tuples, like the reference's dataset adapter
    (``benchmarks/dataset/SimpleReutersAdapter.h`` line-format files)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    vocab = np.asarray(_build_vocab(vocab_size), dtype=object)

    # Zipf-ish rank-frequency: p(rank) ~ 1 / (rank + 2.7)^1.07 (Reuters-ish)
    ranks = np.arange(vocab_size, dtype=np.float64)
    probs = 1.0 / np.power(ranks + 2.7, 1.07)
    probs /= probs.sum()

    # Pre-compute cumulative for fast sampling
    cdf = np.cumsum(probs)

    phrase_arrays = [np.asarray(p, dtype=object) for p in PHRASES]

    for d in range(num_docs):
        body_len = max(5, int(rng.lognormal(np.log(mean_len), 0.7)))
        u = rng.random(body_len)
        idx = np.searchsorted(cdf, u)
        words = vocab[np.minimum(idx, vocab_size - 1)]

        # Inject phrase bigrams/trigram: ~8% of docs get 1-3 occurrences of
        # one of the benchmark phrases at random offsets.
        if rng.random() < 0.08:
            phrase = phrase_arrays[int(rng.integers(len(phrase_arrays)))]
            n_occ = int(rng.integers(1, 4))
            for _ in range(n_occ):
                if body_len > len(phrase) + 1:
                    off = int(rng.integers(0, body_len - len(phrase)))
                    words[off : off + len(phrase)] = phrase

        body = " ".join(words.tolist())
        title_len = int(rng.integers(3, 9))
        u = rng.random(title_len)
        tidx = np.searchsorted(cdf, u)
        title = " ".join(vocab[np.minimum(tidx, vocab_size - 1)].tolist())
        date = f"{(d % 28) + 1:02d}-FEB-1987 15:01:{d % 60:02d}.00"
        yield date, title, body


def corpus_documents(num_docs: int = REUTERS_DOC_COUNT, **kw):
    """Documents shaped exactly like the reference benchmark ingests them
    (SimpleReutersAdapter.h:80-96: title/body TextFields with positions,
    date StringField)."""
    from diagon_tpu_torch.document.document import Document, StringField, TextField

    for date, title, body in generate_reuters_like(num_docs, **kw):
        doc = Document()
        doc.add(TextField("title", title))
        doc.add(TextField("body", body))
        doc.add(StringField("date", date))
        yield doc
