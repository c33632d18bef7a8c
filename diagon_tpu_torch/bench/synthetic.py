"""The Reuters-shaped synthetic vocabulary: the port's own copy of the
parts of ``diagon_tpu/bench/synthetic.py`` that the segment builder
(``bench/bulk_build.py``) uses.

The corpus has 19,043 documents by default (the count the reference
indexes), a Zipf-distributed vocabulary of ~30k terms with the reference
benchmark's query terms planted at high-frequency ranks, log-normal body
lengths and injected phrase bigrams.
"""

from __future__ import annotations

from typing import List

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
