"""The port's Reuters-21578 adapter (``diagon_tpu_torch.bench.reuters``)
against the JAX package's (``diagon_tpu.bench.reuters``) on small SGML and
``.txt`` trees the tests write themselves (the corpus is not in the
repository): the same (date, title, body) tuples, and
``load_real_reuters_segment`` builds a segment equal to the JAX one's,
compared as ``test_torch_writer.py`` compares segments. Its cache file has
a name of its own, and the JAX pickle beside it is never read."""

import os
import pickle

import pytest

from diagon_tpu.bench import reuters as jreuters
from diagon_tpu_torch.bench import reuters

from test_torch_memory_index import assert_segments_equal

SGML = [
    b"""<!DOCTYPE lewis SYSTEM "lewis.dtd">
<REUTERS TOPICS="YES" LEWISSPLIT="TRAIN" NEWID="1">
<DATE>26-FEB-1987 15:01:01.79</DATE>
<TEXT>&#2;
<TITLE>BAHIA COCOA REVIEW</TITLE>
<DATELINE>    SALVADOR, Feb 26 - </DATELINE><BODY>Showers continued throughout
the week in the Bahia cocoa zone &lt;alleviating&gt; the drought &amp; more.
 Reuter
&#3;</BODY></TEXT>
</REUTERS>
<REUTERS TOPICS="NO" NEWID="2">
<DATE>26-FEB-1987 15:02:20.00</DATE>
<TEXT TYPE="BRIEF">&#2;
<TITLE>NO BODY HERE</TITLE>
</TEXT>
</REUTERS>
<REUTERS TOPICS="NO" NEWID="3">
<DATE>26-FEB-1987 15:03:27.51</DATE>
<TEXT>&#2;
<TITLE>EMPTY</TITLE>
<BODY>  Reuter
&#3;</BODY></TEXT>
</REUTERS>
""",
    b"""<REUTERS TOPICS="YES" NEWID="4">
<DATE> 2-MAR-1987 09:00:00.00</DATE>
<TEXT>&#2;
<BODY>Oil prices rose sharply as OPEC met in Vienna; crude oil
futures gained 40 cts a barrel. Caf\xe9 owners cheered.
 Reuter
&#3;</BODY></TEXT>
</REUTERS>
<REUTERS TOPICS="YES" NEWID="5">
<DATE> 2-MAR-1987 09:05:00.00</DATE>
<TEXT>&#2;
<TITLE>TRADE &amp; MARKETS</TITLE>
<BODY>The trade deficit narrowed &#38; market prices held.
Reuter</BODY></TEXT>
</REUTERS>
""",
]

TXT = {
    "a/0001.txt": "26-FEB-1987\n\nCOCOA\n\nShowers in the cocoa zone.\n"
                  "More rain next week.\n",
    "a/0002.txt": "27-FEB-1987\n\nEMPTY BODY\n\n\n\n",
    "b/0003.txt": "28-FEB-1987\n\nOIL\n\nOil prices rose.\n\nCrude gained.",
    "b/short.txt": "only\none line\n",
    "0004.txt": "1-MAR-1987\n\nTRADE\n\ntrade deficit narrowed\n",
    "notes.md": "not an article\n",
}


@pytest.fixture
def sgml_dir(tmp_path):
    d = tmp_path / "sgml"
    d.mkdir()
    for i, data in enumerate(SGML):
        (d / f"reut2-{i:03d}.sgm").write_bytes(data)
    (d / "README.txt").write_text("ignored: .sgm files take precedence\n")
    return str(d)


@pytest.fixture
def txt_dir(tmp_path):
    d = tmp_path / "txt"
    for name, text in TXT.items():
        p = d / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text, encoding="latin-1")
    return str(d)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """DIAGON_CACHE_DIR in tmp_path, for both adapters (the JAX module
    reads its cache directory when it is imported)."""
    d = tmp_path / "cache"
    d.mkdir()
    monkeypatch.setenv("DIAGON_CACHE_DIR", str(d))
    monkeypatch.setattr(jreuters, "CACHE_DIR", str(d))
    return d


def test_sgml_articles_equal_the_jax_iterator(sgml_dir):
    got = list(reuters.iter_sgml_articles(sgml_dir))
    assert got == list(jreuters.iter_sgml_articles(sgml_dir))
    assert [t for _, t, _ in got] == ["BAHIA COCOA REVIEW", "",
                                      "TRADE & MARKETS"]
    assert got[0][2].endswith("& more.")  # entities, no sigil
    assert "Café" in got[1][2]


def test_txt_articles_equal_the_jax_iterator(txt_dir):
    got = list(reuters.iter_txt_articles(txt_dir))
    assert got == list(jreuters.iter_txt_articles(txt_dir))
    assert [d for d, _, _ in got] == ["1-MAR-1987", "26-FEB-1987",
                                      "28-FEB-1987"]


@pytest.mark.parametrize("layout", ["sgml", "txt"])
def test_segment_equals_the_jax_adapter(layout, sgml_dir, txt_dir, cache_dir):
    path = sgml_dir if layout == "sgml" else txt_dir
    seg, stats = reuters.load_real_reuters_segment(path)
    jseg, jstats = jreuters.load_real_reuters_segment(path)
    assert_segments_equal(seg, jseg)
    assert stats["num_docs"] == jstats["num_docs"] == seg.num_docs
    assert set(stats) == set(jstats)
    assert type(seg).__module__.startswith("diagon_tpu_torch.")
    # the second call reads the port's own cache file
    cached = cache_dir / reuters.CACHE_NAME
    assert cached.exists() and reuters.CACHE_NAME != "segment_real_reuters.pkl"
    again, _ = reuters.load_real_reuters_segment(path)
    assert_segments_equal(again, seg)


def test_never_reads_the_jax_cache(sgml_dir, cache_dir):
    """A JAX pickle under the JAX name is left alone: the port builds its
    own segment."""
    jreuters.load_real_reuters_segment(sgml_dir)
    assert (cache_dir / "segment_real_reuters.pkl").exists()
    with open(cache_dir / "segment_real_reuters.pkl", "wb") as f:
        pickle.dump("not a segment", f)
    seg, stats = reuters.load_real_reuters_segment(sgml_dir)
    assert seg.num_docs == stats["num_docs"] == 3


def test_no_path_gives_none(cache_dir, monkeypatch, tmp_path):
    monkeypatch.delenv("DIAGON_REUTERS_PATH", raising=False)
    assert reuters.load_real_reuters_segment() is None
    assert jreuters.load_real_reuters_segment() is None
    assert reuters.load_real_reuters_segment(str(tmp_path / "absent")) is None
    monkeypatch.setenv("DIAGON_REUTERS_PATH", str(tmp_path / "absent"))
    assert reuters.load_real_reuters_segment() is None
    empty = tmp_path / "empty"
    empty.mkdir()
    assert reuters.load_real_reuters_segment(str(empty)) is None
    assert jreuters.load_real_reuters_segment(str(empty)) is None
    assert os.listdir(cache_dir) == []
