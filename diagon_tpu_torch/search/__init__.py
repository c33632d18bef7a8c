"""Search on one PyTorch device: the port of ``diagon_tpu.search``. Query
and result types are the port's own copies of the JAX package's."""

from diagon_tpu_torch.search.bm25 import BM25Params, BM25Similarity  # noqa: F401
from diagon_tpu_torch.search.query import (  # noqa: F401
    BooleanClause,
    BooleanQuery,
    DoubleRangeQuery,
    MatchAllDocsQuery,
    NumericRangeQuery,
    Occur,
    PhraseQuery,
    PointRangeQuery,
    Query,
    TermQuery,
)
from diagon_tpu_torch.search.searcher import IndexSearcher  # noqa: F401
from diagon_tpu_torch.search.topdocs import ScoreDoc, TopDocs  # noqa: F401
