"""The benchmark's plain reference: BM25 top-k from the corpus's own token
arrays, in numpy and plain torch operations. It imports nothing of the
program under test."""

from reference.bm25 import Reference

__all__ = ["Reference"]
