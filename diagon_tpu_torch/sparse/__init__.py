"""Sparse-vector search (learned-sparse / SPLADE-style retrieval) on one
PyTorch device: the port of ``diagon_tpu.sparse``.

Quantized weights ride the packed 128-doc block format of text postings,
and scoring runs on the row engine with an identity LUT: the sparse dot
product is a disjunctive weighted term query.
"""

from diagon_tpu_torch.sparse.vector import SparseVector  # noqa: F401
from diagon_tpu_torch.sparse.index import SparseIndex, SparseSearcher  # noqa: F401
