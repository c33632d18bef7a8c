"""Tokenizers: the port's own copy of ``diagon_tpu/analysis/tokenizers.py``.

``standard_tokenize`` reproduces the reference's indexing-time tokenizer
exactly (``util/StandardTokenizer.h:113-152`` ASCII fast path, reached from
``document/Field.h:110`` -> ``FreqProxTermsWriter.cpp:75``): a token starts at
an ASCII alphanumeric character, continues over alphanumerics and apostrophes,
and is lowercased. Non-ASCII input falls back to a Unicode word-ish splitter
(the reference uses ICU UAX#29; we approximate with Python ``str.isalnum``
runs, which matches for the benchmark corpora which are pure ASCII).

ASCII text goes to the port's host tokenizer (``csrc/host/ingest.cpp``,
the JAX extension's ``standard_tokenize_ascii``), which is built at first
use; a failed build raises. ``_standard_tokenize_ascii_py`` is kept as its
plain reference, which the tests hold it against.
"""

from __future__ import annotations

from typing import List

_ASCII_ALNUM = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
)
_ASCII_ALNUM_APOS = _ASCII_ALNUM | {"'"}

def _is_ascii(text: str) -> bool:
    try:
        text.encode("ascii")
        return True
    except UnicodeEncodeError:
        return False


def _standard_tokenize_ascii_py(text: str) -> List[str]:
    tokens: List[str] = []
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        if c not in _ASCII_ALNUM:
            i += 1
            continue
        start = i
        i += 1
        while i < n and text[i] in _ASCII_ALNUM_APOS:
            i += 1
        tokens.append(text[start:i].lower())
    return tokens


def _is_ideograph(ch: str) -> bool:
    """Han / Hiragana code points, which UAX#29 segments one-per-word
    (the reference's ICU BreakIterator does the same; Katakana and Hangul
    form runs under UAX#29 and stay runs here)."""
    cp = ord(ch)
    return (
        0x4E00 <= cp <= 0x9FFF      # CJK Unified Ideographs
        or 0x3400 <= cp <= 0x4DBF   # CJK Extension A
        or 0xF900 <= cp <= 0xFAFF   # CJK Compatibility Ideographs
        or 0x20000 <= cp <= 0x2A6DF  # CJK Extension B
        or 0x3040 <= cp <= 0x309F   # Hiragana
    )


def _standard_tokenize_unicode(text: str) -> List[str]:
    # Approximation of the reference's ICU BreakIterator path
    # (StandardTokenizer.h:68 tokenizeICU): split on runs of alphanumeric
    # code points, keep tokens containing a letter or digit, lowercase.
    # Han/Hiragana ideographs are emitted one token per character, matching
    # UAX#29 (and Lucene's StandardTokenizer) on Chinese/Japanese text.
    # ANALYSIS-COMPAT NOTE: before 70d964b the 'standard' analyzer emitted
    # CJK RUNS as single tokens; indexes holding CJK text built with that
    # code do not match queries analyzed by this one — reindex them.
    tokens: List[str] = []
    cur: List[str] = []

    def flush():
        if cur:
            tokens.append("".join(cur).lower())
            cur.clear()

    for ch in text:
        if _is_ideograph(ch):
            flush()
            tokens.append(ch)
        elif ch.isalnum() or (ch == "'" and cur):
            cur.append(ch)
        else:
            flush()
    flush()
    return tokens


# CJK ranges that the bigram tokenizer pairs up: the ideograph set above
# plus Katakana and Hangul syllables (Lucene CJKTokenizer's CJK class).
def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (
        _is_ideograph(ch)
        or 0x30A0 <= cp <= 0x30FF   # Katakana
        or 0x31F0 <= cp <= 0x31FF   # Katakana phonetic extensions
        or 0xAC00 <= cp <= 0xD7AF   # Hangul syllables
    )


def cjk_bigram_tokenize(text: str) -> List[str]:
    """CJK-aware tokenization: CJK runs become overlapping character
    bigrams (a single character if the run has length 1); everything else
    follows the standard alnum-run rules, lowercased.

    This is the JAX package's replacement for the reference's dictionary
    segmenter (``JiebaTokenizer.h:40-46`` MIX-mode cppjieba, which needs a
    ~100 MB dictionary): overlapping bigrams are the classic
    self-contained CJK indexing scheme (Lucene ``CJKAnalyzer``) — every
    dictionary word of length >= 2 is covered by its bigrams, so phrase
    and boolean recall match dictionary segmentation at slightly lower
    precision.
    """
    tokens: List[str] = []
    cur: List[str] = []  # pending non-CJK alnum run
    run: List[str] = []  # pending CJK run

    def flush_cur():
        if cur:
            tokens.append("".join(cur).lower())
            cur.clear()

    def flush_run():
        if len(run) == 1:
            tokens.append(run[0])
        else:
            for i in range(len(run) - 1):
                tokens.append(run[i] + run[i + 1])
        run.clear()

    for ch in text:
        if _is_cjk(ch):
            flush_cur()
            run.append(ch)
        elif ch.isalnum() or (ch == "'" and cur):
            if run:
                flush_run()
            cur.append(ch)
        else:
            flush_cur()
            if run:
                flush_run()
    flush_cur()
    if run:
        flush_run()
    return tokens


def standard_tokenize(text: str) -> List[str]:
    """Lucene-StandardTokenizer-compatible tokenization (lowercased)."""
    if not text:
        return []
    if _is_ascii(text):
        from diagon_tpu_torch import native

        return native.standard_tokenize_ascii(text)
    return _standard_tokenize_unicode(text)


def whitespace_tokenize(text: str) -> List[str]:
    """Split on whitespace only; no case folding.

    Mirrors the reference's ``util/FastTokenizer.h`` / WhitespaceTokenizer.
    """
    return text.split()


def keyword_tokenize(text: str) -> List[str]:
    """Whole input as a single token (reference KeywordTokenizer)."""
    return [text] if text else []


class StandardTokenizer:
    def tokenize(self, text: str) -> List[str]:
        return standard_tokenize(text)


class CJKBigramTokenizer:
    def tokenize(self, text: str) -> List[str]:
        return cjk_bigram_tokenize(text)


class WhitespaceTokenizer:
    def tokenize(self, text: str) -> List[str]:
        return whitespace_tokenize(text)


class KeywordTokenizer:
    def tokenize(self, text: str) -> List[str]:
        return keyword_tokenize(text)
