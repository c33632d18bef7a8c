"""The port's embedding API (``diagon_tpu_torch.api``) against the JAX
package's (``diagon_tpu.api``): the same 88 ``C_API_MAP`` keys, the full
lifecycle of ``tests/integration/test_api_end_to_end.py`` and the
functional probes of ``tests/unit/test_c_api_surface.py`` through both
APIs in two temporary directories (the port's searcher on the CPU), with
equal results: docids, f32 scores, hit counts and arrays. A seeded corpus
session (four segments, a numeric field, term / boolean / phrase / range
queries, the terms and postings enums, doc values and histograms) is held
against the JAX API and the port's oracle, and the index the port writes
through the API passes ``tools/validate_bundle.py --deep``, whose report
the port's own validator (``diagon_tpu_torch.validate_bundle``) gives line
for line, on sound and on damaged indexes."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import diagon_tpu.api as jdg
import diagon_tpu_torch.api as dg

ROOT = Path(__file__).resolve().parents[1]


def _kw(api):
    """The port's searcher runs on the CPU here; the JAX one takes none."""
    return {"device": "cpu"} if api is dg else {}


def _hits(hits):
    return [(int(d), float(s)) for d, s in hits]


def test_c_api_map_has_the_jax_keys():
    assert sorted(dg.C_API_MAP) == sorted(jdg.C_API_MAP)
    assert len(dg.C_API_MAP) == 88
    for name, fn in dg.C_API_MAP.items():
        assert callable(fn), name
        # each entry is the port's own function of the JAX entry's name
        assert fn.__module__ == "diagon_tpu_torch.api", name
        assert fn.__name__ == jdg.C_API_MAP[name].__name__, name


def test_nothing_in_the_api_picks_a_device():
    import inspect

    for name in ("open_searcher", "create_index_searcher"):
        sig = inspect.signature(getattr(dg, name))
        assert sig.parameters["device"].default == "cuda"
    src = inspect.getsource(dg)
    assert "is_available" not in src and "import torch" not in src


# ---------------------------------------------------------------------------
# tests/integration/test_api_end_to_end.py::test_full_lifecycle
# ---------------------------------------------------------------------------


def _lifecycle(api, path):
    path = str(path)
    out = {}
    w = api.open_writer(path, max_buffered_docs=3)
    api.add_document(w, {"body": "oil price rises on supply cuts",
                         "views": 10, "tag!": "energy",
                         "_stored": {"id": "a"}})
    api.add_document(w, {"body": "trade deficit widens",
                         "views": 20, "_stored": {"id": "b"}})
    api.add_document(w, {"body": "oil futures fall; price drops",
                         "views": 30, "_stored": {"id": "c"}})
    api.add_document(w, {"body": "grain exports steady",
                         "views": 40, "_stored": {"id": "d"}})
    api.commit(w)
    api.force_merge(w, 1)
    api.commit_merge_results(w)
    api.close_writer(w)

    r = api.open_reader(path)
    out["num_docs"] = api.num_docs(r)
    s = api.open_searcher(r, **_kw(api))
    hits = api.search(s, api.term_query("body", "oil"), k=10)
    out["oil"] = _hits(hits)
    out["doc"] = api.get_document(r, hits[0][0])
    total, hits = api.search_with_total(
        s, api.boolean_query(should=[api.term_query("body", "oil"),
                                     api.term_query("body", "trade")]))
    out["or"] = (total, _hits(hits))
    out["phrase"] = _hits(api.search(
        s, api.phrase_query("body", ["oil", "price"]), k=10))
    out["range"] = _hits(api.search(
        s, api.numeric_range_query("views", 15, 35), k=10))
    out["point"] = _hits(api.search(
        s, api.point_range_query("views", 35, None), k=10))
    out["tag"] = api.count(s, api.term_query("tag", "energy"))
    out["all"] = api.count(s, api.match_all_query())

    w = api.open_writer(path)
    api.update_document(w, "body", "grain",
                        {"body": "grain exports surge",
                         "_stored": {"id": "d2"}})
    api.commit(w)
    api.close_writer(w)
    r2 = api.reopen(r)
    s2 = api.open_searcher(r2, **_kw(api))
    out["surge"] = api.count(s2, api.term_query("body", "surge"))
    out["steady"] = api.count(s2, api.term_query("body", "steady"))
    out["grain"] = _hits(api.search(s2, api.term_query("body", "grain")))
    return out


def test_full_lifecycle(tmp_path):
    got = _lifecycle(dg, tmp_path / "port")
    assert got == _lifecycle(jdg, tmp_path / "jax")
    assert got["num_docs"] == 4
    assert sorted(d for d, _ in got["oil"]) == [0, 2]
    assert got["doc"]["id"] in ("a", "c")
    assert got["or"][0] == 3
    assert [d for d, _ in got["phrase"]] == [0]
    assert sorted(d for d, _ in got["range"]) == [1, 2]
    assert [d for d, _ in got["point"]] == [3]
    assert (got["tag"], got["all"]) == (1, 4)
    assert (got["surge"], got["steady"]) == (1, 0)


# ---------------------------------------------------------------------------
# tests/unit/test_c_api_surface.py's probes, through both APIs
# ---------------------------------------------------------------------------


def _c_api_index(api, path):
    path = str(path)
    cfg = api.create_index_writer_config()
    api.config_set_ram_buffer_size(cfg, 8.0)
    api.config_set_open_mode(cfg, 0)  # CREATE
    api.config_set_commit_on_close(cfg, True)
    api.config_set_use_compound_file(cfg, True)
    w = api.create_index_writer(path, cfg)
    for i, body in enumerate(
        ["oil price rose", "oil supply cut", "trade deal done"]
    ):
        d = api.create_document()
        api.document_add_field(d, api.create_text_field("body", body))
        api.document_add_field(d, api.create_long_field("views", 10 * i))
        api.document_add_field(d, api.create_double_field("price", 1.5 * i))
        api.document_add_field(
            d, api.create_double_point_field("ts", 1000.0 + i))
        api.document_add_field(d, api.create_indexed_long_field("rank", i))
        api.document_add_field(d, api.create_stored_field("title", f"doc {i}"))
        api.add_document(w, d)
    api.commit(w)
    api.close_writer(w)
    return path


def _error_discipline(api, path):
    api.clear_error()
    out = [api.last_error()]
    out.append(api.pcall(api.open_index_reader, str(Path(path) / "missing")))
    out.append(api.last_error().split(":")[0])
    api.clear_error()
    out.append(api.last_error())
    return out


def _reader_accessors(api, path):
    r = api.open_index_reader(path)
    doc = api.reader_get_document(r, 0)
    s = api.create_index_searcher(r, **_kw(api))
    td = api.search_top_docs(s, api.create_term_query(("rank", "2")), 5)
    return [api.reader_max_doc(r), api.reader_num_docs(r),
            api.reader_get_segment_count(r),
            api.document_get_field_value(doc, "title"),
            api.document_get_long_value(doc, "rank"),
            api.top_docs_total_hits(td)]


def _top_docs_accessors(api, path):
    r = api.open_index_reader(path)
    s = api.create_index_searcher(r, **_kw(api))
    td = api.search_top_docs(s, api.create_term_query(("body", "oil")), 5)
    sds = [api.top_docs_score_doc_at(td, i)
           for i in range(api.top_docs_score_docs_length(td))]
    api.free(td)
    return [api.top_docs_total_hits(td), api.top_docs_max_score(td),
            [(api.score_doc_get_doc(sd), api.score_doc_get_score(sd))
             for sd in sds]]


def _terms_and_postings(api, path):
    r = api.open_index_reader(path)
    te = api.reader_get_terms(r, "body")
    terms = []
    while api.terms_enum_next(te):
        pe = api.terms_enum_get_postings(te)
        docs = []
        while (d := api.postings_next_doc(pe)) != -1:
            docs.append((d, api.postings_freq(pe)))
        terms.append((api.terms_enum_get_term(te),
                      api.terms_enum_doc_freq(te), docs))
    return [terms, api.reader_get_terms(r, "nofield")]


def _doc_values(api, path):
    r = api.open_index_reader(path)
    out = []
    for field, ids in (("views", [2, 0, 99]), ("price", [1, 2]),
                       ("title", [0])):
        vals, found = api.reader_get_numeric_doc_values_bulk(r, field, ids)
        out.append((vals.tolist(), found.tolist()))
    for field in ("views", "price"):
        sv, valid = api.reader_scan_numeric_doc_values(r, field)
        out.append((sv.tolist(), valid.tolist()))
    return out


def _histograms(api, path):
    r = api.open_index_reader(path)
    counts, total = api.compute_histogram(r, "ts", 1000.0, 1.0, 4)
    s = api.create_index_searcher(r, **_kw(api))
    keys, dcounts, hits = api.search_with_date_histogram(
        s, api.create_term_query(("body", "oil")), r, "views",
        10.0, 0.0, 30.0)
    return [counts.tolist(), total, keys.tolist(), dcounts.tolist(), hits]


def _bool_builder_and_json(api, path):
    path = str(Path(path) / "j")
    w = api.create_index_writer(path)
    n = api.add_documents_from_json(
        w, '[{"body": "oil up"}, {"body": "oil down"}, {"body": "flat"}]')
    d = api.create_document_from_json_with_id('{"body": "oil idd"}', "x1")
    api.add_document(w, d)
    api.commit(w)
    api.close_writer(w)
    r = api.open_index_reader(path)
    s = api.create_index_searcher(r, **_kw(api))
    b = api.create_bool_query()
    api.bool_query_add_must(b, api.create_term_query(("body", "oil")))
    api.bool_query_add_must_not(b, api.create_term_query(("body", "down")))
    api.bool_query_set_minimum_should_match(b, 0)
    q = api.bool_query_build(b)
    f = api.create_bool_query()
    api.bool_query_add_filter(f, api.create_term_query(("body", "oil")))
    api.bool_query_add_should(f, api.create_term_query(("body", "up")))
    return [n, api.count(s, q), _hits(api.search(s, q)),
            api.count(s, api.create_term_query(api.create_term("_id", "x1"))),
            _hits(api.search(s, api.bool_query_build(f))),
            api.count(s, api.create_match_all_query())]


def _double_queries(api, path):
    r = api.open_index_reader(path)
    s = api.create_index_searcher(r, **_kw(api))
    return [
        api.count(s, api.create_double_range_query("price", 1.0, 2.0)),
        api.count(s, api.create_double_range_query(
            "price", 1.5, 3.0, include_lower=False)),
        api.count(s, api.create_double_point_range_query("ts", 1000.5, None)),
        api.count(s, api.create_numeric_range_query("views", 5, 25)),
        api.count(s, api.double_range_query("price", None, 1.5,
                                            include_upper=False)),
        api.count(s, api.double_point_range_query("ts", None, 1001.0)),
        api.directory_get_size(api.open_fs_directory(path)) > 0,
        api.directory_get_size(api.open_mmap_directory(path)) > 0,
    ]


def _documents(api, path):
    d = api.create_document_from_json({"body": "oil", "n": 3})
    long_field = api.create_indexed_long_field("n", 7)
    dbl = api.create_indexed_double_field("x", 2.5)
    return [
        api.document_get_field_value(d, "body"),
        api.document_get_long_value({"v": "12"}, "v"),
        api.document_get_double_value({"v": 4611686018427387904}, "v"),
        api.document_get_double_value({"v": 1.25}, "v"),
        api.document_get_double_value({}, "v"),
        [(f.name, f.value) for f in long_field],
        [(f.name, f.value) for f in dbl],
        [(f.name, f.value) for f in api.create_text_field("t", "a b", True)],
        api.create_string_field("s", "v", stored=True).value,
        api.create_long_point_field("p", 5).value,
        type(api.make_document({"a": True, "b": 2, "c!": 3,
                                "d": "x"})).__name__,
        [f.name for f in api.make_document({"a": True, "b": 2, "c!": 3,
                                            "d": "x"}).fields],
    ]


PROBES = {
    "error_discipline": (_error_discipline, None),
    "reader_accessors": (_reader_accessors, [3, 3, 1, "doc 0", 0, 1]),
    "top_docs_accessors": (_top_docs_accessors, None),
    "terms_and_postings_enum": (_terms_and_postings, None),
    "numeric_dv_bulk_and_scan": (_doc_values, None),
    "histograms": (_histograms, [[1, 1, 1, 0], 3, [0.0, 10.0, 20.0],
                                 [1, 1, 0], 2]),
    "bool_builder_and_json": (_bool_builder_and_json, None),
    "double_queries_via_api": (_double_queries,
                               [1, 1, 2, 2, 1, 2, True, True]),
    "documents_and_fields": (_documents, None),
}


@pytest.fixture(scope="module")
def c_api_indexes(tmp_path_factory):
    base = tmp_path_factory.mktemp("c_api")
    return {api: _c_api_index(api, base / api.__name__) for api in (dg, jdg)}


@pytest.mark.parametrize("name", sorted(PROBES))
def test_c_api_probe_equals_jax(c_api_indexes, tmp_path, name):
    probe, want = PROBES[name]
    if name in ("error_discipline", "bool_builder_and_json"):
        got = probe(dg, tmp_path / "port")
        assert got == probe(jdg, tmp_path / "jax")
    else:
        got = probe(dg, c_api_indexes[dg])
        assert got == probe(jdg, c_api_indexes[jdg])
    if want is not None:
        assert got == want


def test_c_api_probes_hold_the_jax_suites_values(c_api_indexes, tmp_path):
    """The values tests/unit/test_c_api_surface.py asserts, on the port."""
    path = c_api_indexes[dg]
    err = _error_discipline(dg, tmp_path)
    assert err[0] == "" and err[1] is None and err[2] == "FileNotFoundError"
    assert err[3] == ""
    total, best, sds = _top_docs_accessors(dg, path)
    assert total == 2 and len(sds) == 2
    assert sds[0][0] in (0, 1) and sds[0][1] > 0 and best == sds[0][1]
    terms, missing = _terms_and_postings(dg, path)
    seen = {t: df for t, df, _ in terms}
    assert seen["oil"] == 2 and seen["trade"] == 1 and missing is None
    assert dict((t, p) for t, _, p in terms)["oil"] == [(0, 1), (1, 1)]
    dv = _doc_values(dg, path)
    assert dv[0] == ([20.0, 0.0, 0.0], [True, True, False])
    assert dv[1] == ([1.5, 3.0], [True, True])
    assert dv[3] == ([0.0, 10.0, 20.0], [True, True, True])
    n, c, _, idd, _, _ = _bool_builder_and_json(dg, tmp_path / "b")
    assert (n, c, idd) == (3, 2, 1)


def test_open_index_reader_without_a_commit_raises(tmp_path):
    from diagon_tpu_torch.index.writer import find_latest_commit_gen
    from diagon_tpu_torch.store import FSDirectory

    assert find_latest_commit_gen(FSDirectory(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        dg.open_index_reader(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        jdg.open_index_reader(str(tmp_path))


def test_the_api_written_index_validates(c_api_indexes):
    r = subprocess.run(
        [sys.executable, "tools/validate_bundle.py", c_api_indexes[dg],
         "--deep"],
        capture_output=True, text=True, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "RESULT: OK" in r.stdout


def _validators(path):
    """The JAX tool's and the port's validator (``python -m``) on one
    index: (returncode, stdout) of each."""
    runs = []
    for cmd in (["tools/validate_bundle.py"],
                ["-m", "diagon_tpu_torch.validate_bundle"]):
        r = subprocess.run([sys.executable, *cmd, str(path), "--deep"],
                           capture_output=True, text=True, cwd=ROOT)
        runs.append((r.returncode, r.stdout))
    return runs


def test_the_port_validator_reports_as_the_tool(c_api_indexes, session):
    """diagon_tpu_torch.validate_bundle prints the tool's report, line for
    line, on the C-API index and on the four-segment session index."""
    for path in (c_api_indexes[dg], session[dg][0].directory.path):
        jax_run, port_run = _validators(path)
        assert port_run == jax_run
        assert port_run[0] == 0 and "RESULT: OK" in port_run[1]


@pytest.mark.parametrize("damage", ["flipped_byte", "no_commit"])
def test_the_port_validator_finds_damage(c_api_indexes, tmp_path, damage):
    """A flipped byte in a segment bundle fails its checksum and an index
    without a commit has no generation: both validators say so, in the
    same words, and exit 1."""
    import shutil

    path = tmp_path / "idx"
    shutil.copytree(c_api_indexes[dg], path)
    if damage == "flipped_byte":
        bundle = sorted(path.glob("*.bnd"))[0]
        raw = bytearray(bundle.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        bundle.write_bytes(bytes(raw))
    else:
        for f in path.glob("segments_*"):
            f.unlink()
    jax_run, port_run = _validators(path)
    assert port_run == jax_run
    assert port_run[0] == 1 and "RESULT: OK" not in port_run[1]


# ---------------------------------------------------------------------------
# a seeded session over a Reuters-shaped corpus: four segments through the
# C-API form, queries of every family, enums, doc values and histograms
# ---------------------------------------------------------------------------

N_DOCS = 600


def _session_index(api, path):
    from diagon_tpu.bench.synthetic import corpus_documents as jcorpus
    from diagon_tpu_torch.bench.synthetic import corpus_documents

    docs = list((corpus_documents if api is dg else jcorpus)(N_DOCS))
    views = np.random.default_rng(13).integers(0, 100_000, N_DOCS)
    for doc, v in zip(docs, views):
        api.document_add_field(doc, api.create_indexed_long_field("views",
                                                                  int(v)))
        api.document_add_field(doc, api.create_long_point_field("views",
                                                                int(v)))
    cfg = api.create_index_writer_config()
    api.config_set_max_buffered_docs(cfg, N_DOCS // 4)
    w = api.create_index_writer(str(path), cfg)
    assert api.add_documents(w, docs) == N_DOCS
    api.commit(w)
    api.close_writer(w)
    return str(path), views


def _session_queries(api, searcher):
    if api is dg:
        from diagon_tpu_torch.bench import queries as bq
    else:
        from diagon_tpu.bench import queries as bq
    pool = bq.frequent_terms(searcher)
    qs = bq.mixed_query_batch(pool, 24, seed=42, phrase_share=5)
    qs += [api.phrase_query("body", p) for p in bq.PHRASES[:2]]
    qs += [
        api.boolean_query(must=[api.term_query("body", pool[0])],
                          should=[api.term_query("body", pool[5])],
                          must_not=[api.term_query("body", pool[9])]),
        api.numeric_range_query("views", 20_000, 60_000),
        api.double_point_range_query("views", 90_000, None),
        api.boolean_query(must=[api.term_query("body", pool[1])],
                          filter_=[api.numeric_range_query("views", 0,
                                                           50_000)]),
        api.match_all_query(),
    ]
    return qs


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    base = tmp_path_factory.mktemp("session")
    out = {}
    for api in (dg, jdg):
        path, views = _session_index(api, base / api.__name__)
        r = api.open_index_reader(path)
        s = api.create_index_searcher(r, **_kw(api))
        out[api] = (r, s, _session_queries(api, s), views)
    return out


def _topdocs(td):
    return (td.total_hits, [(sd.doc, float(sd.score))
                            for sd in td.score_docs])


def test_session_has_four_segments(session):
    r = session[dg][0]
    assert dg.reader_get_segment_count(r) == 4
    assert dg.reader_num_docs(r) == N_DOCS


def test_session_queries_equal_jax_and_oracle(session):
    from diagon_tpu_torch.search.oracle import OracleSearcher

    r, s, qs, _ = session[dg]
    jr, js, jqs, _ = session[jdg]
    oracle = OracleSearcher(r.segments_data())
    assert len(qs) == len(jqs) == 31
    for q, jq in zip(qs, jqs):
        got = _topdocs(dg.search_top_docs(s, q, 10))
        assert got == _topdocs(oracle.search(q, 10)), q
        assert got == _topdocs(jdg.search_top_docs(js, jq, 10)), q
        assert dg.count(s, q) == oracle.count(q) == jdg.count(js, jq), q


def test_session_enums_equal_jax_and_oracle(session):
    from diagon_tpu_torch.search.oracle import OracleSearcher

    r = session[dg][0]
    jr = session[jdg][0]
    out = {}
    for api, reader in ((dg, r), (jdg, jr)):
        te = api.reader_get_terms(reader, "body")
        rows = []
        while api.terms_enum_next(te) and len(rows) < 40:
            pe = api.terms_enum_get_postings(te)
            docs = []
            while (d := api.postings_next_doc(pe)) != -1:
                docs.append((d, api.postings_freq(pe)))
            rows.append((api.terms_enum_get_term(te),
                         api.terms_enum_doc_freq(te), docs))
        out[api] = rows
    assert out[dg] == out[jdg]
    segs = r.segments_data()
    bases = np.cumsum([0] + [sg.num_docs for sg in segs])
    for term, df, docs in out[dg]:
        want = []
        for base, sg in zip(bases, segs):
            d, f = OracleSearcher._term_postings(sg, "body", term)
            want += [(int(x) + int(base), int(y)) for x, y in zip(d, f)]
        assert docs == want and df == len(want), term


def test_session_doc_values_and_histograms_equal_numpy(session):
    r, s, qs, views = session[dg]
    jr, js, jqs, _ = session[jdg]
    ids = [5, 0, N_DOCS - 1, 77, N_DOCS + 3]
    vals, found = dg.reader_get_numeric_doc_values_bulk(r, "views", ids)
    jvals, jfound = jdg.reader_get_numeric_doc_values_bulk(jr, "views", ids)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(found, jfound)
    assert found.tolist() == [True] * 4 + [False]
    np.testing.assert_array_equal(vals[:4], views[ids[:4]].astype(np.float64))
    sv, valid = dg.reader_scan_numeric_doc_values(r, "views")
    assert valid.all()
    np.testing.assert_array_equal(sv, views.astype(np.float64))
    counts, total = dg.compute_histogram(r, "views", 0.0, 10_000.0, 10)
    jcounts, jtotal = jdg.compute_histogram(jr, "views", 0.0, 10_000.0, 10)
    np.testing.assert_array_equal(counts, jcounts)
    assert total == jtotal == N_DOCS
    np.testing.assert_array_equal(
        counts, np.bincount(views // 10_000, minlength=10))
    q, jq = qs[0], jqs[0]
    keys, hc, hits = dg.search_with_date_histogram(
        s, q, r, "views", 7_000.0, 0.0, 100_000.0)
    jkeys, jhc, jhits = jdg.search_with_date_histogram(
        js, jq, jr, "views", 7_000.0, 0.0, 100_000.0)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(hc, jhc)
    assert hits == jhits == dg.count(s, q)
    assert len(keys) == 15  # ceil(100000 / 7000)
