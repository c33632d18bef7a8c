"""Analyzer = tokenizer + filter chain, plus the prebuilt factory: the
port's own copy of ``diagon_tpu/analysis/analyzer.py``.

Mirrors the reference's ``analysis/Analyzer.h`` ``CompositeAnalyzer`` and
``AnalyzerFactory.cpp:14-89`` — all 8 prebuilt analyzers: whitespace /
keyword / simple / standard / english / search / multilingual / chinese
(the chinese analyzer replaces cppjieba dictionary segmentation with a
self-contained CJK bigram tokenizer; see ``tokenizers.cjk_bigram_tokenize``).
"""

from __future__ import annotations

from typing import List, Sequence

from diagon_tpu_torch.analysis.filters import (
    ASCIIFoldingFilter,
    CHINESE_STOP_WORDS,
    ENGLISH_STOP_WORDS,
    LowercaseFilter,
    StopFilter,
    TokenFilter,
)
from diagon_tpu_torch.analysis.tokenizers import (
    CJKBigramTokenizer,
    KeywordTokenizer,
    StandardTokenizer,
    WhitespaceTokenizer,
)


class Analyzer:
    def analyze(self, text: str) -> List[str]:
        raise NotImplementedError


class CompositeAnalyzer(Analyzer):
    def __init__(self, tokenizer, filters: Sequence[TokenFilter] = ()):
        self.tokenizer = tokenizer
        self.filters = list(filters)

    def analyze(self, text: str) -> List[str]:
        tokens = self.tokenizer.tokenize(text)
        for f in self.filters:
            tokens = f.filter(tokens)
        return tokens


class StandardAnalyzer(CompositeAnalyzer):
    """StandardTokenizer (already lowercases). The index-time default."""

    def __init__(self):
        super().__init__(StandardTokenizer(), [])


class WhitespaceAnalyzer(CompositeAnalyzer):
    def __init__(self):
        super().__init__(WhitespaceTokenizer(), [])


class KeywordAnalyzer(CompositeAnalyzer):
    def __init__(self):
        super().__init__(KeywordTokenizer(), [])


class EnglishAnalyzer(CompositeAnalyzer):
    """Standard tokenizer (lowercases) + ASCII folding + English stops
    (reference ``AnalyzerFactory::createEnglish``)."""

    def __init__(self):
        super().__init__(
            StandardTokenizer(),
            [ASCIIFoldingFilter(), StopFilter(ENGLISH_STOP_WORDS)],
        )


class SimpleAnalyzer(CompositeAnalyzer):
    def __init__(self):
        super().__init__(WhitespaceTokenizer(), [LowercaseFilter()])


class SearchAnalyzer(CompositeAnalyzer):
    """Query-side chain: folding + stops (``createSearch``)."""

    def __init__(self):
        super().__init__(
            StandardTokenizer(),
            [ASCIIFoldingFilter(), StopFilter(ENGLISH_STOP_WORDS)],
        )


class MultilingualAnalyzer(CompositeAnalyzer):
    """Standard tokenizer + ASCII folding, no language-specific stops
    (``createMultilingual``); the tokenizer emits Han/Hiragana ideographs
    one-per-token like the reference's ICU path."""

    def __init__(self):
        super().__init__(StandardTokenizer(), [ASCIIFoldingFilter()])


class ChineseAnalyzer(CompositeAnalyzer):
    """CJK bigram tokenizer + Chinese stop words.

    The reference's ``createChinese`` wraps cppjieba MIX-mode dictionary
    segmentation (``JiebaTokenizer.h:40-46``); this redesign uses
    overlapping CJK bigrams (Lucene-CJKAnalyzer scheme) which need no
    dictionary and preserve phrase/boolean recall.
    """

    def __init__(self):
        super().__init__(
            CJKBigramTokenizer(), [StopFilter(CHINESE_STOP_WORDS)]
        )


_FACTORY = {
    "standard": StandardAnalyzer,
    "whitespace": WhitespaceAnalyzer,
    "keyword": KeywordAnalyzer,
    "english": EnglishAnalyzer,
    "simple": SimpleAnalyzer,
    "search": SearchAnalyzer,
    "multilingual": MultilingualAnalyzer,
    "chinese": ChineseAnalyzer,
}


def analyzer_for_name(name: str) -> Analyzer:
    """Factory lookup (reference ``AnalyzerFactory::create``)."""
    try:
        return _FACTORY[name]()
    except KeyError:
        raise ValueError(
            f"unknown analyzer {name!r}; available: {sorted(_FACTORY)}"
        ) from None
