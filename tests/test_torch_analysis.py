"""The port's analysis package (``diagon_tpu_torch.analysis``) against the
JAX package's: the cases of ``tests/unit/test_analysis.py``, each also
required equal to the JAX answer, and the host tokenizer
(``csrc/host/ingest.cpp``) against its plain Python reference and the JAX
``standard_tokenize`` on seeded random ASCII."""

import numpy as np
import pytest

import diagon_tpu.analysis as JA
from diagon_tpu_torch import native
from diagon_tpu_torch.analysis import (
    ENGLISH_STOP_WORDS,
    ASCIIFoldingFilter,
    StopFilter,
    SynonymFilter,
    analyzer_for_name,
    cjk_bigram_tokenize,
    keyword_tokenize,
    standard_tokenize,
    whitespace_tokenize,
)
from diagon_tpu_torch.analysis.tokenizers import _standard_tokenize_ascii_py


def _same(name, *args):
    """The port's function ``name`` of the analysis package, equal to the
    JAX one on ``args``; returns the port's answer."""
    import diagon_tpu_torch.analysis as TA

    got = getattr(TA, name)(*args)
    assert got == getattr(JA, name)(*args), (name, args)
    return got


def test_standard_tokenize_basic():
    assert _same("standard_tokenize", "Hello, World!") == ["hello", "world"]


def test_standard_tokenize_alnum_and_apostrophe():
    # Apostrophe continues a token but cannot start one.
    assert _same("standard_tokenize", "don't stop") == ["don't", "stop"]
    assert _same("standard_tokenize", "'quoted'") == ["quoted'"]


def test_standard_tokenize_numbers():
    assert _same("standard_tokenize", "Q3 earnings rose 12.5 pct") == [
        "q3", "earnings", "rose", "12", "5", "pct",
    ]


def test_standard_tokenize_punct_runs():
    assert _same("standard_tokenize", "a--b__c") == ["a", "b", "c"]
    assert _same("standard_tokenize", "...") == []
    assert standard_tokenize("") == []


def test_standard_tokenize_unicode_fallback():
    assert _same("standard_tokenize", "café prices") == ["café", "prices"]


def test_whitespace_and_keyword():
    assert _same("whitespace_tokenize", "Foo  Bar\tbaz") == ["Foo", "Bar", "baz"]
    assert _same("keyword_tokenize", "New York") == ["New York"]
    assert keyword_tokenize("") == []
    assert whitespace_tokenize("") == []


def test_stop_filter():
    f = StopFilter(ENGLISH_STOP_WORDS)
    assert f.filter(["the", "oil", "price", "of", "it"]) == ["oil", "price"]
    assert ENGLISH_STOP_WORDS == JA.ENGLISH_STOP_WORDS
    assert JA.CHINESE_STOP_WORDS == __import__(
        "diagon_tpu_torch.analysis", fromlist=["x"]).CHINESE_STOP_WORDS


def test_synonym_filter():
    f = SynonymFilter({"usa": ["usa", "america"]})
    assert f.filter(["the", "usa"]) == ["the", "usa", "america"]


def test_ascii_folding():
    f = ASCIIFoldingFilter()
    assert f.filter(["café"]) == ["cafe"]
    assert f.filter(["café", "日本"]) == JA.ASCIIFoldingFilter().filter(
        ["café", "日本"])


def test_analyzer_factory():
    a = analyzer_for_name("standard")
    assert a.analyze("Oil Prices!") == ["oil", "prices"]
    e = analyzer_for_name("english")
    assert e.analyze("The oil price") == ["oil", "price"]
    with pytest.raises(ValueError):
        analyzer_for_name("nope")


def test_cjk_bigram_tokenize():
    # CJK runs -> overlapping bigrams; a lone ideograph stays a unigram.
    assert _same("cjk_bigram_tokenize", "北京大学") == ["北京", "京大", "大学"]
    assert _same("cjk_bigram_tokenize", "茶") == ["茶"]
    # Mixed script: latin words follow standard rules, runs split bigrams.
    assert _same("cjk_bigram_tokenize", "IBM 在北京") == ["ibm", "在北", "北京"]
    # Punctuation breaks a CJK run (no bigram across the comma).
    assert _same("cjk_bigram_tokenize", "北京，大学") == ["北京", "大学"]
    assert cjk_bigram_tokenize("") == []


def test_chinese_analyzer_stops():
    a = analyzer_for_name("chinese")
    # "的" alone is a stopword unigram; inside a run it still bigrams.
    assert a.analyze("我 的 书") == ["书"]  # 我/的 stopped, 书 kept
    toks = a.analyze("中国的发展")
    assert "中国" in toks and "发展" in toks
    assert toks == JA.analyzer_for_name("chinese").analyze("中国的发展")


def test_multilingual_analyzer():
    a = analyzer_for_name("multilingual")
    # folding + lowercase, no English stops, Han one-per-token (UAX#29).
    assert a.analyze("The Café") == ["the", "cafe"]
    assert a.analyze("東京 Tokyo") == ["東", "京", "tokyo"]


def test_english_analyzer_folds_and_stops():
    e = analyzer_for_name("english")
    assert e.analyze("The résumé") == ["resume"]


def test_chinese_field_end_to_end():
    from diagon_tpu_torch.document import Document, TextField
    from diagon_tpu_torch.index.memory_index import MemoryIndex
    from diagon_tpu_torch.index.segment import flush_memory_index
    from diagon_tpu_torch.search import IndexSearcher, PhraseQuery, TermQuery

    mem = MemoryIndex()
    texts = ["北京大学的学生", "上海交通大学", "天气很好"]
    for t in texts:
        mem.add_document(
            Document().add(TextField("body", t, analyzer="chinese"))
        )
    seg = flush_memory_index(mem, "_zh")
    s = IndexSearcher([seg], device="cpu")
    td = s.search(TermQuery("body", "大学"), k=10)
    assert sorted(td.doc_ids()) == [0, 1]
    # phrase over bigram tokens: "北京" followed by "京大" = 北京大...
    td = s.search(PhraseQuery("body", ["北京", "京大"]), k=10)
    assert td.doc_ids() == [0]
    assert s.search(TermQuery("body", "天气"), k=10).doc_ids() == [2]


@pytest.mark.parametrize("name", ["whitespace", "keyword", "simple",
                                  "standard", "english", "search",
                                  "multilingual", "chinese"])
def test_every_analyzer_matches_jax(name):
    """Each of the eight prebuilt analyzers gives the JAX analyzer's
    tokens on mixed-script text."""
    text = ("The Café's OIL-price rose 12.5% in Q3; 北京大学的学生 "
            "東京 résumé don't 'x' Ünïcödé")
    assert (analyzer_for_name(name).analyze(text)
            == JA.analyzer_for_name(name).analyze(text))


_ALPHABET = np.array(list("abcXYZ019' \t\n.,-_!?'\"()[]{}/\\;:@#$%^&*+=<>~`|"
                          "qrstuvwMNOPQ"))


@pytest.mark.parametrize("seed", range(6))
def test_host_tokenizer_matches_plain_and_jax(seed):
    """The host tokenizer equals the plain Python tokenizer and the JAX
    package's ``standard_tokenize`` on seeded random ASCII texts, long
    tokens (past the accumulator's 256-byte stack buffer) included."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n = int(rng.integers(0, 400))
        text = "".join(rng.choice(_ALPHABET, n))
        if rng.random() < 0.2:
            text += " " + "A1b" * int(rng.integers(80, 120)) + " tail"
        want = _standard_tokenize_ascii_py(text)
        assert native.standard_tokenize_ascii(text) == want
        assert standard_tokenize(text) == want
        assert JA.standard_tokenize(text) == want


@pytest.mark.parametrize("seed", range(3))
def test_host_accumulator_tokens_match_the_tokenizer(seed):
    """FreqProx's fast tokenizer (lowercase and hash in one pass) finds the
    tokens of the plain one: per doc, its token count and the terms with
    their freqs and positions."""
    rng = np.random.default_rng(100 + seed)
    texts = []
    for _ in range(50):
        text = "".join(rng.choice(_ALPHABET, int(rng.integers(0, 300))))
        if rng.random() < 0.3:
            text += " " + "Zz9" * 100
        texts.append(text)
    fp = native.FreqProx()
    counts = fp.add_documents(0, texts, True)
    out = fp.finish(True)
    want = {}
    for d, text in enumerate(texts):
        toks = _standard_tokenize_ascii_py(text)
        assert counts[d] == len(toks)
        for p, t in enumerate(toks):
            want.setdefault(t, {}).setdefault(d, []).append(p)
    assert out["terms"] == sorted(want)
    es, ps = out["entry_start"], out["pos_start"]
    for i, t in enumerate(out["terms"]):
        docs = out["docs"][es[i]:es[i + 1]].tolist()
        assert docs == sorted(want[t])
        for j, d in enumerate(docs, start=int(es[i])):
            assert out["freqs"][j] == len(want[t][d])
            assert out["positions"][ps[j]:ps[j + 1]].tolist() == want[t][d]
