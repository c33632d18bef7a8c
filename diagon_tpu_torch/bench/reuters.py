"""Real Reuters-21578 dataset adapter: the port's copy of
``diagon_tpu/bench/reuters.py``.

One article per document with ``title`` / ``body`` TextFields and a
``date`` StringField; articles with an empty body are skipped (21,578
articles index as 19,043 documents). Either layout the dataset ships in:

- a directory tree of per-article ``.txt`` files (date / blank / title /
  blank / body lines), the Lucene-benchmark extraction; or
- the original distribution's ``reut2-0??.sgm`` SGML files, parsed here.

``DIAGON_REUTERS_PATH`` names the dataset directory. The segment the
adapter builds with the port's ``MemoryIndex`` is cached in the bench
cache (``bench/cache.py``) under a name of its own,
``segment_real_reuters_torch.pkl``: the JAX package's pickle beside it
holds JAX classes and is never read here.
"""

from __future__ import annotations

import html
import os
import pickle
import re
import time
from typing import Iterator, Optional, Tuple

from diagon_tpu_torch.bench.cache import bench_cache_dir

CACHE_NAME = "segment_real_reuters_torch.pkl"

_SGM_DOC = re.compile(rb"<REUTERS\b.*?</REUTERS>", re.S)
_SGM_FIELD = {
    "title": re.compile(rb"<TITLE>(.*?)</TITLE>", re.S),
    "body": re.compile(rb"<BODY>(.*?)</BODY>", re.S),
    "date": re.compile(rb"<DATE>(.*?)</DATE>", re.S),
}


def _unescape(raw: bytes) -> str:
    # Reuters SGML uses a small entity set (&lt; &gt; &amp; &#NNN;)
    return html.unescape(raw.decode("latin-1")).strip()


def iter_sgml_articles(path: str) -> Iterator[Tuple[str, str, str]]:
    """(date, title, body) per article from the ``*.sgm`` files of
    ``path``, in file-name order."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".sgm"))
    for fn in files:
        with open(os.path.join(path, fn), "rb") as f:
            data = f.read()
        for m in _SGM_DOC.finditer(data):
            chunk = m.group(0)
            body = _SGM_FIELD["body"].search(chunk)
            if body is None:
                continue
            text = _unescape(body.group(1))
            # the distribution ends bodies with a "Reuter &#3;" sigil
            text = re.sub(r"\s*Reuter\s*\x03?\s*$", "", text)
            if not text:
                continue
            title = _SGM_FIELD["title"].search(chunk)
            date = _SGM_FIELD["date"].search(chunk)
            yield (
                _unescape(date.group(1)) if date else "",
                _unescape(title.group(1)) if title else "",
                text,
            )


def iter_txt_articles(path: str) -> Iterator[Tuple[str, str, str]]:
    """(date, title, body) per extracted ``.txt`` article file under
    ``path``, in path order."""
    files = []
    for root, _dirs, names in os.walk(path):
        files.extend(os.path.join(root, n) for n in names if n.endswith(".txt"))
    for fp in sorted(files):
        with open(fp, encoding="latin-1") as f:
            lines = f.read().split("\n")
        if len(lines) < 3:
            continue
        date, title = lines[0], lines[2]
        body = " ".join(line for line in lines[4:] if line).strip()
        if not body:
            continue
        yield date, title, body


def load_real_reuters_segment(path: Optional[str] = None):
    """(segment, build_stats) for the real corpus, or None when no path is
    given and ``DIAGON_REUTERS_PATH`` is unset or not a directory. The
    flushed segment is cached."""
    path = path or os.environ.get("DIAGON_REUTERS_PATH")
    if not path or not os.path.isdir(path):
        return None
    has_sgm = any(f.endswith(".sgm") for f in os.listdir(path))
    cache = os.path.join(bench_cache_dir(), CACHE_NAME)
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            return pickle.load(f)

    from diagon_tpu_torch.document import Document, StringField, TextField
    from diagon_tpu_torch.index.memory_index import MemoryIndex
    from diagon_tpu_torch.index.segment import flush_memory_index

    it = iter_sgml_articles(path) if has_sgm else iter_txt_articles(path)
    t0 = time.time()
    docs = [
        Document()
        .add(TextField("title", title))
        .add(TextField("body", body))
        .add(StringField("date", date))
        for date, title, body in it
    ]
    t_parse = time.time() - t0
    if not docs:
        return None
    mem = MemoryIndex()
    t0 = time.time()
    for d in docs:
        mem.add_document(d)
    t_ingest = time.time() - t0
    t0 = time.time()
    seg = flush_memory_index(mem, "_reuters")
    t_flush = time.time() - t0
    stats = {
        "parse_s": round(t_parse, 2),
        "ingest_s": round(t_ingest, 2),
        "flush_s": round(t_flush, 2),
        "docs_per_s": round(len(docs) / max(t_ingest + t_flush, 1e-9)),
        "num_docs": len(docs),
    }
    with open(cache, "wb") as f:
        pickle.dump((seg, stats), f, protocol=4)
    return seg, stats
