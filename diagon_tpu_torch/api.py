"""Flat embedding API — the stable integration surface: the port's
counterpart of ``diagon_tpu/api.py``, function for function.

The role of the reference's C API (``c_api/diagon_c_api.h:48-307``: flat
handle-based functions over writer/reader/searcher/document for FFI
embedders). In a Python-first framework the embedding surface is a small,
stable module of plain functions over opaque handles; everything maps 1:1
to a ``diagon_*`` C function in the reference (``C_API_MAP``). The writer,
reader, store, queries and searchers under it are the port's own.

    import diagon_tpu_torch.api as dg
    w = dg.open_writer(path)
    dg.add_document(w, {"body": "oil price rises", "views": 42})
    dg.commit(w)
    dg.close_writer(w)

    r = dg.open_reader(path)
    s = dg.open_searcher(r)                  # on the CUDA card
    s = dg.open_searcher(r, device="cpu")    # the plain versions
    hits = dg.search(s, dg.term_query("body", "oil"), k=10)
    # hits = [(global_docid, score), ...]

The searcher constructors take the device and pass it on; nothing here
picks one.
"""

from __future__ import annotations

import json
import struct
import threading
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from diagon_tpu_torch.document.document import (
    TEXT_FIELD_TYPE,
    Document,
    DoubleDocValuesField,
    DoublePointField,
    LongPointField,
    NumericDocValuesField,
    StoredField,
    StringField,
    TextField,
    replace,
)
from diagon_tpu_torch.document.json_parser import JsonDocumentParser
from diagon_tpu_torch.index.reader import DirectoryReader
from diagon_tpu_torch.index.writer import (
    IndexWriter,
    IndexWriterConfig,
    find_latest_commit_gen,
)
from diagon_tpu_torch.search.oracle import OracleSearcher
from diagon_tpu_torch.search.query import (
    BooleanQuery,
    DoubleRangeQuery,
    MatchAllDocsQuery,
    NumericRangeQuery,
    Occur,
    PhraseQuery,
    PointRangeQuery,
    Query,
    Term,
    TermQuery,
)
from diagon_tpu_torch.search.searcher import IndexSearcher
from diagon_tpu_torch.store.directory import FSDirectory


# -- directories / writer lifecycle (diagon_directory_*, diagon_writer_*) --

def open_writer(
    path: str,
    ram_buffer_mb: float = 16.0,
    max_buffered_docs: int = -1,
    open_mode: str = "CREATE_OR_APPEND",
) -> IndexWriter:
    return IndexWriter(
        FSDirectory(path),
        IndexWriterConfig(
            ram_buffer_mb=ram_buffer_mb,
            max_buffered_docs=max_buffered_docs,
            open_mode=open_mode,
        ),
    )


def add_document(writer: IndexWriter, doc: Union[Document, Dict]) -> int:
    """Dict values: str -> TextField; int -> NumericDocValues+LongPoint;
    '<name>!' keyword suffix -> StringField; stored under '_stored'."""
    if isinstance(doc, dict):
        doc = make_document(doc)
    return writer.add_document(doc)


def make_document(fields: Dict) -> Document:
    d = Document()
    for name, value in fields.items():
        if name == "_stored" and isinstance(value, dict):
            for k, v in value.items():
                d.add(StoredField(k, v))
        elif name.endswith("!"):
            d.add(StringField(name[:-1], str(value)))
        elif isinstance(value, bool):
            d.add(StringField(name, "true" if value else "false"))
        elif isinstance(value, int):
            d.add(NumericDocValuesField(name, value))
            d.add(LongPointField(name, value))
        else:
            d.add(TextField(name, str(value)))
    return d


def delete_documents(writer: IndexWriter, field: str, term: str) -> int:
    return writer.delete_documents(field, term)


def update_document(writer, field: str, term: str, doc: Union[Document, Dict]) -> int:
    if isinstance(doc, dict):
        doc = make_document(doc)
    return writer.update_document(field, term, doc)


def flush(writer: IndexWriter) -> None:
    writer.flush()


def commit(writer: IndexWriter) -> int:
    return writer.commit()


def force_merge(writer: IndexWriter, max_segments: int = 1) -> None:
    writer.force_merge(max_segments)


def wait_for_merges(writer: IndexWriter) -> None:
    writer.wait_for_merges()


def commit_merge_results(writer: IndexWriter) -> int:
    return writer.commit_merge_results()


def rollback(writer: IndexWriter) -> None:
    writer.rollback()


def close_writer(writer: IndexWriter) -> None:
    writer.close()


# -- reader / searcher (diagon_reader_*, diagon_searcher_*) ----------------

def open_reader(path: str) -> DirectoryReader:
    return DirectoryReader.open(FSDirectory(path))


def reopen(reader: DirectoryReader) -> DirectoryReader:
    return reader.reopen()


def open_searcher(reader: DirectoryReader, device="cuda") -> IndexSearcher:
    return IndexSearcher(reader, device=device)


def num_docs(reader: DirectoryReader) -> int:
    return reader.num_docs()


def get_document(reader: DirectoryReader, doc_id: int) -> Dict:
    return reader.document(doc_id)


# -- queries (diagon_query_*) -----------------------------------------------

def term_query(field: str, text: str, boost: float = 1.0) -> TermQuery:
    return TermQuery(field, text, boost)


def boolean_query(
    must: Sequence[Query] = (),
    should: Sequence[Query] = (),
    filter_: Sequence[Query] = (),
    must_not: Sequence[Query] = (),
    minimum_should_match: int = 0,
) -> BooleanQuery:
    b = BooleanQuery.Builder()
    for q in must:
        b.add(q, Occur.MUST)
    for q in should:
        b.add(q, Occur.SHOULD)
    for q in filter_:
        b.add(q, Occur.FILTER)
    for q in must_not:
        b.add(q, Occur.MUST_NOT)
    b.set_minimum_number_should_match(minimum_should_match)
    return b.build()


def phrase_query(field: str, terms: Sequence[str]) -> PhraseQuery:
    return PhraseQuery(field, list(terms))


def match_all_query() -> MatchAllDocsQuery:
    return MatchAllDocsQuery()


def numeric_range_query(field: str, lower=None, upper=None) -> NumericRangeQuery:
    return NumericRangeQuery(field, lower, upper)


def point_range_query(field: str, lower=None, upper=None) -> PointRangeQuery:
    return PointRangeQuery(field, lower, upper)


def double_range_query(
    field: str,
    lower: Optional[float] = None,
    upper: Optional[float] = None,
    include_lower: bool = True,
    include_upper: bool = True,
) -> DoubleRangeQuery:
    """diagon_create_double_range_query (doc-values scan)."""
    return DoubleRangeQuery(field, lower, upper, include_lower, include_upper)


def double_point_range_query(
    field: str, lower: Optional[float] = None, upper: Optional[float] = None
) -> PointRangeQuery:
    """diagon_create_double_point_range_query (BKD-role point columns)."""
    return PointRangeQuery(field, lower, upper)


# -- execution ---------------------------------------------------------------

def search(
    searcher: IndexSearcher, query: Query, k: int = 10
) -> List[Tuple[int, float]]:
    td = searcher.search(query, k)
    return [(sd.doc, sd.score) for sd in td.score_docs]


def search_with_total(searcher: IndexSearcher, query: Query, k: int = 10):
    td = searcher.search(query, k)
    return td.total_hits, [(sd.doc, sd.score) for sd in td.score_docs]


def count(searcher: IndexSearcher, query: Query) -> int:
    return searcher.count(query)


# =============================================================================
# Full C-API surface (diagon_c_api.h:48-307 parity)
#
# Every ``diagon_*`` declaration in the reference header maps to exactly
# one entry in C_API_MAP at the bottom of this module (the JAX package's
# map, key for key: tests/test_torch_api.py). Handle lifetime functions
# (``diagon_free_*`` / ``diagon_close_directory``) map to ``free`` — a
# documented no-op, Python handles are garbage-collected.
# =============================================================================

# -- error handling (diagon_last_error / diagon_clear_error) -----------------

_tls = threading.local()


def last_error() -> str:
    """Thread-local last error message ('' if none), set by pcall()."""
    return getattr(_tls, "err", "")


def clear_error() -> None:
    _tls.err = ""


def pcall(fn, *args, **kwargs):
    """C-style error discipline: returns None on failure and records the
    message for last_error() (the reference sets a thread-local in every
    wrapper, diagon_c_api.cpp set_error). Python embedders normally just
    let exceptions propagate; FFI-style embedders use this."""
    try:
        return fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 — the point of the wrapper
        _tls.err = f"{type(exc).__name__}: {exc}"
        return None


def free(handle) -> None:
    """diagon_free_* / diagon_close_directory: no-op (GC-managed)."""


# -- directories --------------------------------------------------------------

def open_fs_directory(path: str) -> FSDirectory:
    return FSDirectory(path)


def open_mmap_directory(path: str) -> FSDirectory:
    """FSDirectory already serves reads through np.memmap views of the
    .bnd bundle (store/format.py), so the mmap variant IS FSDirectory."""
    return FSDirectory(path)


def directory_get_size(directory) -> int:
    return sum(directory.file_length(f) for f in directory.list_files())


# -- writer config ------------------------------------------------------------

_OPEN_MODES = {0: "CREATE", 1: "APPEND", 2: "CREATE_OR_APPEND"}


def create_index_writer_config() -> IndexWriterConfig:
    return IndexWriterConfig()


def config_set_ram_buffer_size(config: IndexWriterConfig, size_mb: float):
    config.ram_buffer_mb = float(size_mb)


def config_set_max_buffered_docs(config: IndexWriterConfig, max_docs: int):
    config.max_buffered_docs = int(max_docs)


def config_set_open_mode(config: IndexWriterConfig, mode: Union[int, str]):
    config.open_mode = _OPEN_MODES.get(mode, mode)


def config_set_commit_on_close(config: IndexWriterConfig, commit: bool):
    config.commit_on_close = bool(commit)


def config_set_use_compound_file(config: IndexWriterConfig, use: bool):
    """Accepted for signature parity: the .bnd bundle is ALWAYS the
    compound file in this format (store/format.py) — nothing to toggle."""


def create_index_writer(directory, config=None) -> IndexWriter:
    if isinstance(directory, str):
        directory = FSDirectory(directory)
    return IndexWriter(directory, config or IndexWriterConfig())


def maybe_merge(writer: IndexWriter) -> None:
    writer.maybe_merge()


def add_documents(writer: IndexWriter, docs: Sequence[Union[Document, Dict]]) -> int:
    n = 0
    for d in docs:
        add_document(writer, d)
        n += 1
    return n


# -- JSON ingestion -----------------------------------------------------------

def create_document_from_json(json_data: Union[str, bytes, Dict]) -> Document:
    return JsonDocumentParser().parse(json_data)


def create_document_from_json_with_id(
    json_data: Union[str, bytes, Dict], doc_id: str
) -> Document:
    d = create_document_from_json(json_data)
    d.add(StringField("_id", doc_id, stored=True))
    return d


def add_documents_from_json(writer: IndexWriter, json_array: Union[str, bytes]) -> int:
    arr = json.loads(json_array)
    if not isinstance(arr, list):
        raise ValueError("expected a JSON array of objects")
    for obj in arr:
        writer.add_document(create_document_from_json(obj))
    return len(arr)


# -- document / field constructors (diagon_create_*_field) --------------------

def create_document() -> Document:
    return Document()


def document_add_field(doc: Document, field) -> None:
    """Accepts one Field or the list-of-fields composites that
    indexed_long_field / indexed_double_field return."""
    for f in field if isinstance(field, (list, tuple)) else (field,):
        doc.add(f)


def create_text_field(name: str, value: str, stored: bool = False) -> List:
    fields: List = [TextField(name, value, ftype=(
        replace(TEXT_FIELD_TYPE, stored=False)))]
    if stored:
        fields.append(StoredField(name, value))
    return fields


def create_string_field(name: str, value: str, stored: bool = False) -> StringField:
    return StringField(name, value, stored=stored)


def create_stored_field(name: str, value) -> StoredField:
    return StoredField(name, value)


def create_long_field(name: str, value: int) -> NumericDocValuesField:
    """diagon_create_long_field: NUMERIC doc values."""
    return NumericDocValuesField(name, int(value))


def create_double_field(name: str, value: float):
    """diagon_create_double_field: double bit-cast into NUMERIC doc
    values (diagon_c_api.cpp:441)."""
    return DoubleDocValuesField(name, value)


def create_long_point_field(name: str, value: int) -> LongPointField:
    return LongPointField(name, int(value))


def create_double_point_field(name: str, value: float):
    return DoublePointField(name, float(value))


def create_indexed_long_field(name: str, value: int) -> List:
    """Indexed (keyword term) + stored + NUMERIC doc values, the
    reference composite (diagon_c_api.cpp create_indexed_long_field)."""
    return [
        StringField(name, str(int(value)), stored=True),
        NumericDocValuesField(name, int(value)),
    ]


def create_indexed_double_field(name: str, value: float) -> List:
    return [
        StringField(name, repr(float(value)), stored=True),
        DoubleDocValuesField(name, float(value)),
    ]


def document_get_field_value(doc: Union[Document, Dict], name: str):
    """Field value by name from a Document or a stored-fields dict
    (reader.document returns the dict form)."""
    if isinstance(doc, dict):
        return doc.get(name)
    for f in doc.fields:
        if f.name == name:
            return f.value
    return None


def document_get_long_value(doc, name: str) -> Optional[int]:
    v = document_get_field_value(doc, name)
    return None if v is None else int(v)


def document_get_double_value(doc, name: str) -> Optional[float]:
    v = document_get_field_value(doc, name)
    if v is None:
        return None
    if isinstance(v, int):  # bit-cast convention for double DV fields
        return struct.unpack("<d", struct.pack("<q", v))[0]
    return float(v)


# -- terms / queries ----------------------------------------------------------

def create_term(field: str, text: str):
    return Term(field, text)


def create_term_query(term) -> TermQuery:
    """Accepts a Term (diagon_create_term) or (field, text)."""
    if isinstance(term, tuple):
        return TermQuery(term[0], term[1])
    return TermQuery(term.field, term.text)


def create_bool_query() -> BooleanQuery.Builder:
    return BooleanQuery.Builder()


def bool_query_add_must(b: BooleanQuery.Builder, q: Query) -> None:
    b.add(q, Occur.MUST)


def bool_query_add_should(b: BooleanQuery.Builder, q: Query) -> None:
    b.add(q, Occur.SHOULD)


def bool_query_add_filter(b: BooleanQuery.Builder, q: Query) -> None:
    b.add(q, Occur.FILTER)


def bool_query_add_must_not(b: BooleanQuery.Builder, q: Query) -> None:
    b.add(q, Occur.MUST_NOT)


def bool_query_set_minimum_should_match(b: BooleanQuery.Builder, n: int):
    b.set_minimum_number_should_match(n)


def bool_query_build(b: BooleanQuery.Builder) -> BooleanQuery:
    return b.build()


def create_match_all_query() -> MatchAllDocsQuery:
    return MatchAllDocsQuery()


def create_numeric_range_query(field: str, lower=None, upper=None):
    return NumericRangeQuery(field, lower, upper)


def create_double_range_query(
    field: str, lower=None, upper=None,
    include_lower: bool = True, include_upper: bool = True,
) -> DoubleRangeQuery:
    return DoubleRangeQuery(field, lower, upper, include_lower, include_upper)


def create_double_point_range_query(field: str, lower=None, upper=None):
    return PointRangeQuery(field, lower, upper)


# -- searcher / TopDocs -------------------------------------------------------

def create_index_searcher(reader, device="cuda") -> IndexSearcher:
    return IndexSearcher(reader, device=device)


def search_top_docs(searcher: IndexSearcher, query: Query, k: int = 10):
    """diagon_search: the TopDocs-handle form of search()."""
    return searcher.search(query, k)


def top_docs_total_hits(td) -> int:
    return td.total_hits


def top_docs_max_score(td) -> float:
    return max((sd.score for sd in td.score_docs), default=float("nan"))


def top_docs_score_docs_length(td) -> int:
    return len(td.score_docs)


def top_docs_score_doc_at(td, i: int):
    return td.score_docs[i]


def score_doc_get_doc(sd) -> int:
    return sd.doc


def score_doc_get_score(sd) -> float:
    return sd.score


# -- reader accessors ---------------------------------------------------------

def open_index_reader(directory) -> DirectoryReader:
    """Raises FileNotFoundError when no commit exists at the path (the
    reference returns NULL + sets the error; Lucene's
    IndexNotFoundException) — use pcall() for the C-style form."""
    if isinstance(directory, str):
        directory = FSDirectory(directory)
    if find_latest_commit_gen(directory) is None:
        raise FileNotFoundError(
            f"no segments_N commit in {getattr(directory, 'path', directory)}"
        )
    return DirectoryReader.open(directory)


def close_index_reader(reader) -> None:
    free(reader)


def reader_max_doc(reader: DirectoryReader) -> int:
    return reader.max_doc()


def reader_num_docs(reader: DirectoryReader) -> int:
    return reader.num_docs()


def reader_get_segment_count(reader: DirectoryReader) -> int:
    return len(reader.leaves())


def reader_get_document(reader: DirectoryReader, doc_id: int) -> Dict:
    return reader.document(doc_id)


# -- terms / postings enumeration ---------------------------------------------

class TermsEnum:
    """Cursor over a field's sorted term dictionary across segments
    (diagon_reader_get_terms / diagon_terms_enum_*). Array-oriented
    inside; the cursor surface exists for FFI-style embedders."""

    def __init__(self, reader: DirectoryReader, field: str):
        self._segs = [
            (base, leaf.reader.data)
            for leaf, base in zip(reader.leaves(),
                                  _leaf_bases(reader))
            if field in leaf.reader.data.fields
        ]
        self.field = field
        # merged sorted unique terms with per-term total df
        df = Counter()
        for _, seg in self._segs:
            pp = seg.fields[field].postings
            for t, n in zip(pp.terms, pp.doc_freq):
                df[t] += int(n)
        self._terms = sorted(df)
        self._df = df
        self._i = -1

    def next(self) -> bool:
        self._i += 1
        return self._i < len(self._terms)

    def term(self) -> str:
        return self._terms[self._i]

    def doc_freq(self) -> int:
        return self._df[self._terms[self._i]]

    def postings(self) -> "PostingsEnum":
        return PostingsEnum(self._segs, self.field, self.term())


class PostingsEnum:
    """Cursor over one term's (docid, freq) postings in global docid
    order (diagon_postings_next_doc / diagon_postings_freq)."""

    def __init__(self, segs, field: str, text: str):
        ds, fs = [], []
        for base, seg in segs:
            d, f = OracleSearcher._term_postings(seg, field, text)
            ds.append(d.astype(np.int64) + base)
            fs.append(f)
        self._docs = np.concatenate(ds) if ds else np.zeros(0, np.int64)
        self._freqs = np.concatenate(fs) if fs else np.zeros(0, np.int64)
        self._i = -1

    def next_doc(self) -> int:
        self._i += 1
        if self._i >= len(self._docs):
            return -1
        return int(self._docs[self._i])

    def freq(self) -> int:
        return int(self._freqs[self._i])


def _leaf_bases(reader: DirectoryReader) -> List[int]:
    return [leaf.doc_base for leaf in reader.leaves()]


def reader_get_terms(reader: DirectoryReader, field: str) -> Optional[TermsEnum]:
    te = TermsEnum(reader, field)
    return te if te._segs else None


def terms_enum_next(te: TermsEnum) -> bool:
    return te.next()


def terms_enum_get_term(te: TermsEnum) -> str:
    return te.term()


def terms_enum_doc_freq(te: TermsEnum) -> int:
    return te.doc_freq()


def terms_enum_get_postings(te: TermsEnum) -> PostingsEnum:
    return te.postings()


def postings_next_doc(pe: PostingsEnum) -> int:
    return pe.next_doc()


def postings_freq(pe: PostingsEnum) -> int:
    return pe.freq()


# -- NumericDocValues bulk access ----------------------------------------------

def reader_get_numeric_doc_values_bulk(
    reader: DirectoryReader, field: str, doc_ids: Sequence[int]
):
    """(values float64 [n], found bool [n]) for the given global docids
    (diagon_reader_get_numeric_doc_values_bulk: column-oriented O(1)
    per doc). Doubles (bit-cast convention) come back as doubles; plain
    longs as their float64 value."""
    ids = np.asarray(doc_ids, dtype=np.int64)
    out = np.zeros(len(ids), np.float64)
    found = np.zeros(len(ids), bool)
    for leaf, base in zip(reader.leaves(), _leaf_bases(reader)):
        seg = leaf.reader.data
        dv = seg.doc_values.get(field)
        if dv is None or dv.value_start is not None:
            continue
        local = ids - base
        sel = (local >= 0) & (local < seg.num_docs)
        if not sel.any():
            continue
        pos = np.searchsorted(dv.docs, local[sel])
        pos = np.clip(pos, 0, max(0, len(dv.docs) - 1))
        hit = (len(dv.docs) > 0) & (dv.docs[pos] == local[sel])
        vals = _decode_numeric(dv.values[pos])
        idx = np.nonzero(sel)[0]
        out[idx[hit]] = vals[hit]
        found[idx[hit]] = True
    return out, found


def reader_scan_numeric_doc_values(reader: DirectoryReader, field: str):
    """(values float64 [max_doc], valid bool [max_doc]) — sequential scan
    (diagon_reader_scan_numeric_doc_values)."""
    out = np.zeros(reader.max_doc(), np.float64)
    valid = np.zeros(reader.max_doc(), bool)
    for leaf, base in zip(reader.leaves(), _leaf_bases(reader)):
        seg = leaf.reader.data
        dv = seg.doc_values.get(field)
        if dv is None or dv.value_start is not None:
            continue
        out[base + dv.docs] = _decode_numeric(dv.values)
        valid[base + dv.docs] = True
    return out, valid


def _decode_numeric(vals):
    """int64 DV words -> float64, honoring the double bit-cast
    convention: values outside the exact-integer range that decode to a
    finite double are doubles; plain longs pass through as floats."""
    as_f = vals.view(np.float64) if vals.dtype == np.int64 else vals
    as_i = vals.astype(np.float64)
    # heuristic from the reference's mixed usage: bit patterns of real
    # doubles have exponents that make |double| in a sane range while
    # the same bits read as int64 are astronomically large
    use_double = np.isfinite(as_f) & (np.abs(vals) > (1 << 52))
    return np.where(use_double, as_f, as_i)


# -- BKD histogram aggregation -------------------------------------------------

def compute_histogram(
    reader: DirectoryReader,
    field: str,
    min_value: float,
    interval: float,
    num_buckets: int,
):
    """(bucket_counts int64 [num_buckets], total) — one vectorized pass
    over the value-sorted point columns (diagon_compute_histogram's
    O(N) BKD traversal becomes a bincount over the sorted values)."""
    counts = np.zeros(num_buckets, np.int64)
    total = 0
    for leaf in reader.leaves():
        pt = leaf.reader.data.points.get(field)
        if pt is None:
            continue
        b = np.floor(
            (pt.values.astype(np.float64) - min_value) / interval
        ).astype(np.int64)
        ok = (b >= 0) & (b < num_buckets)
        counts += np.bincount(b[ok], minlength=num_buckets)
        total += int(len(pt.values))
    return counts, total


def search_with_date_histogram(
    searcher: IndexSearcher,
    query: Query,
    reader: DirectoryReader,
    field: str,
    interval_ms: float,
    min_value: float,
    max_value: float,
):
    """(bucket_keys float64, bucket_counts int64, total_hits) — search +
    single-pass histogram over the matches' NUMERIC doc values
    (diagon_search_with_date_histogram's collector fusion; here the
    match mask comes from the exact scoring path and the histogram is
    one vectorized pass over the matched docs' DV column)."""
    num_buckets = max(1, int(np.ceil((max_value - min_value) / interval_ms)))
    counts = np.zeros(num_buckets, np.int64)
    total_hits = 0
    segs = (
        reader.segments_data()
        if hasattr(reader, "segments_data")
        else list(reader)
    )
    oracle = OracleSearcher(segs)
    for seg in segs:
        _, mask = oracle._score_dense(seg, query)
        dv = seg.doc_values.get(field)
        total_hits += int(mask.sum())
        if dv is None or dv.value_start is not None:
            continue
        sel = mask[dv.docs]
        vals = _decode_numeric(dv.values[sel])
        b = np.floor((vals - min_value) / interval_ms).astype(np.int64)
        ok = (b >= 0) & (b < num_buckets)
        counts += np.bincount(b[ok], minlength=num_buckets)
    keys = min_value + np.arange(num_buckets, dtype=np.float64) * interval_ms
    return keys, counts, total_hits


# -- the 1:1 map (the JAX package's keys: tests/test_torch_api.py) -----------

C_API_MAP = {
    "diagon_last_error": last_error,
    "diagon_clear_error": clear_error,
    "diagon_open_fs_directory": open_fs_directory,
    "diagon_open_mmap_directory": open_mmap_directory,
    "diagon_close_directory": free,
    "diagon_directory_get_size": directory_get_size,
    "diagon_create_index_writer_config": create_index_writer_config,
    "diagon_config_set_ram_buffer_size": config_set_ram_buffer_size,
    "diagon_config_set_max_buffered_docs": config_set_max_buffered_docs,
    "diagon_config_set_open_mode": config_set_open_mode,
    "diagon_config_set_commit_on_close": config_set_commit_on_close,
    "diagon_config_set_use_compound_file": config_set_use_compound_file,
    "diagon_free_index_writer_config": free,
    "diagon_create_index_writer": create_index_writer,
    "diagon_close_index_writer": close_writer,
    "diagon_add_document": add_document,
    "diagon_add_documents": add_documents,
    "diagon_add_documents_from_json": add_documents_from_json,
    "diagon_commit": commit,
    "diagon_flush": flush,
    "diagon_force_merge": force_merge,
    "diagon_maybe_merge": maybe_merge,
    "diagon_wait_for_merges": wait_for_merges,
    "diagon_commit_merge_results": commit_merge_results,
    "diagon_create_document": create_document,
    "diagon_create_document_from_json": create_document_from_json,
    "diagon_create_document_from_json_with_id":
        create_document_from_json_with_id,
    "diagon_document_add_field": document_add_field,
    "diagon_document_get_field_value": document_get_field_value,
    "diagon_document_get_long_value": document_get_long_value,
    "diagon_document_get_double_value": document_get_double_value,
    "diagon_free_document": free,
    "diagon_create_text_field": create_text_field,
    "diagon_create_string_field": create_string_field,
    "diagon_create_stored_field": create_stored_field,
    "diagon_create_long_field": create_long_field,
    "diagon_create_double_field": create_double_field,
    "diagon_create_long_point_field": create_long_point_field,
    "diagon_create_double_point_field": create_double_point_field,
    "diagon_create_indexed_long_field": create_indexed_long_field,
    "diagon_create_indexed_double_field": create_indexed_double_field,
    "diagon_free_field": free,
    "diagon_create_term": create_term,
    "diagon_free_term": free,
    "diagon_create_term_query": create_term_query,
    "diagon_create_bool_query": create_bool_query,
    "diagon_bool_query_add_must": bool_query_add_must,
    "diagon_bool_query_add_should": bool_query_add_should,
    "diagon_bool_query_add_filter": bool_query_add_filter,
    "diagon_bool_query_add_must_not": bool_query_add_must_not,
    "diagon_bool_query_set_minimum_should_match":
        bool_query_set_minimum_should_match,
    "diagon_bool_query_build": bool_query_build,
    "diagon_free_bool_query_builder": free,
    "diagon_create_match_all_query": create_match_all_query,
    "diagon_create_numeric_range_query": create_numeric_range_query,
    "diagon_create_double_range_query": create_double_range_query,
    "diagon_create_double_point_range_query":
        create_double_point_range_query,
    "diagon_free_query": free,
    "diagon_open_index_reader": open_index_reader,
    "diagon_close_index_reader": close_index_reader,
    "diagon_reader_max_doc": reader_max_doc,
    "diagon_reader_num_docs": reader_num_docs,
    "diagon_reader_get_segment_count": reader_get_segment_count,
    "diagon_reader_get_document": reader_get_document,
    "diagon_reader_get_terms": reader_get_terms,
    "diagon_terms_enum_next": terms_enum_next,
    "diagon_terms_enum_get_term": terms_enum_get_term,
    "diagon_terms_enum_doc_freq": terms_enum_doc_freq,
    "diagon_terms_enum_get_postings": terms_enum_get_postings,
    "diagon_free_terms_enum": free,
    "diagon_postings_next_doc": postings_next_doc,
    "diagon_postings_freq": postings_freq,
    "diagon_free_postings_enum": free,
    "diagon_reader_get_numeric_doc_values_bulk":
        reader_get_numeric_doc_values_bulk,
    "diagon_reader_scan_numeric_doc_values":
        reader_scan_numeric_doc_values,
    "diagon_compute_histogram": compute_histogram,
    "diagon_search_with_date_histogram": search_with_date_histogram,
    "diagon_create_index_searcher": create_index_searcher,
    "diagon_free_index_searcher": free,
    "diagon_search": search_top_docs,
    "diagon_count": count,
    "diagon_top_docs_total_hits": top_docs_total_hits,
    "diagon_top_docs_max_score": top_docs_max_score,
    "diagon_top_docs_score_docs_length": top_docs_score_docs_length,
    "diagon_top_docs_score_doc_at": top_docs_score_doc_at,
    "diagon_score_doc_get_doc": score_doc_get_doc,
    "diagon_score_doc_get_score": score_doc_get_score,
    "diagon_free_top_docs": free,
}
