"""Text analysis: tokenizers, token filters, analyzers; the port's own
copy of ``diagon_tpu/analysis``.

Equivalent of the reference's analysis layer (``src/core/include/analysis/``,
SURVEY.md section 2.5). Tokenization is a host-side concern (strings never
reach the device); the ASCII standard tokenizer runs in the port's host C++
(``csrc/host/ingest.cpp``, through ``diagon_tpu_torch.native``).
"""

from diagon_tpu_torch.analysis.tokenizers import (  # noqa: F401
    standard_tokenize,
    whitespace_tokenize,
    keyword_tokenize,
    cjk_bigram_tokenize,
    StandardTokenizer,
    WhitespaceTokenizer,
    KeywordTokenizer,
    CJKBigramTokenizer,
)
from diagon_tpu_torch.analysis.filters import (  # noqa: F401
    LowercaseFilter,
    StopFilter,
    SynonymFilter,
    ASCIIFoldingFilter,
    ENGLISH_STOP_WORDS,
    CHINESE_STOP_WORDS,
)
from diagon_tpu_torch.analysis.analyzer import (  # noqa: F401
    Analyzer,
    CompositeAnalyzer,
    StandardAnalyzer,
    WhitespaceAnalyzer,
    KeywordAnalyzer,
    EnglishAnalyzer,
    SimpleAnalyzer,
    SearchAnalyzer,
    MultilingualAnalyzer,
    ChineseAnalyzer,
    analyzer_for_name,
)
