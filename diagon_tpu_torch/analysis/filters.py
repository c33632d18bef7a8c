"""Token filters: lowercase, stop words, synonyms, ASCII folding; the
port's own copy of ``diagon_tpu/analysis/filters.py``.

Equivalents of the reference's ``analysis/`` filter chain
(``LowercaseFilter``, ``StopFilter``, ``SynonymFilter``,
``ASCIIFoldingFilter`` — SURVEY.md section 2.5).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Sequence

# Lucene's default English stop set (EnglishAnalyzer.ENGLISH_STOP_WORDS_SET).
ENGLISH_STOP_WORDS = frozenset(
    [
        "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
        "in", "into", "is", "it", "no", "not", "of", "on", "or", "such",
        "that", "the", "their", "then", "there", "these", "they", "this",
        "to", "was", "will", "with",
    ]
)


# The reference's Chinese stop set, mirrored exactly
# (StopFilter::getChineseStopWords, StopFilter.cpp:42-68). Under bigram
# tokenization single-character entries match length-1 CJK runs and
# two-character entries match their bigram token directly.
CHINESE_STOP_WORDS = frozenset(
    [
        # articles and particles
        "的", "了", "在", "是", "我", "有", "和", "就", "不", "人", "都",
        "一", "一个", "上", "也", "很", "到", "说", "要", "去", "你", "会",
        "着", "没有", "看", "好", "自己", "这",
        # conjunctions
        "或", "而", "但", "因", "为", "与", "及", "等", "之", "于", "以",
        "由", "从", "向", "对", "把",
        # pronouns
        "他", "她", "它", "我们", "你们", "他们", "那", "哪", "谁", "什么",
        "怎么", "怎样",
        # time/place
        "时", "年", "月", "日", "时候", "这里", "那里", "里", "中", "下",
        "前", "后", "间",
        # quantifiers
        "个", "些", "每", "各", "某", "任",
        # others
        "就是", "只是", "所以", "因为", "虽然", "但是", "如果", "那么",
        "可以", "能够", "应该",
    ]
)


class TokenFilter:
    def filter(self, tokens: List[str]) -> List[str]:
        raise NotImplementedError


class LowercaseFilter(TokenFilter):
    def filter(self, tokens: List[str]) -> List[str]:
        return [t.lower() for t in tokens]


class StopFilter(TokenFilter):
    def __init__(self, stop_words: Iterable[str] = ENGLISH_STOP_WORDS):
        self.stop_words = frozenset(stop_words)

    def filter(self, tokens: List[str]) -> List[str]:
        return [t for t in tokens if t not in self.stop_words]


class SynonymFilter(TokenFilter):
    """Maps tokens through a synonym table (single-token expansion).

    ``synonyms`` maps a token to the list of tokens to emit in its place
    (including itself if it should be kept).
    """

    def __init__(self, synonyms: Dict[str, Sequence[str]]):
        self.synonyms = {k: list(v) for k, v in synonyms.items()}

    def filter(self, tokens: List[str]) -> List[str]:
        out: List[str] = []
        for t in tokens:
            out.extend(self.synonyms.get(t, [t]))
        return out


class ASCIIFoldingFilter(TokenFilter):
    """Fold accented characters to their ASCII base (NFKD strip)."""

    def filter(self, tokens: List[str]) -> List[str]:
        out = []
        for t in tokens:
            folded = unicodedata.normalize("NFKD", t)
            out.append(folded.encode("ascii", "ignore").decode("ascii") or t)
        return out
