"""The port's packages export the public names of the JAX package's
(``__init__`` files compared by AST, not by importing them), with equal
values where the names hold data: ``BM25Params()``, ``REUTERS_QUERIES``
(the JAX queries carried across by ``search.convert``) and
``REFERENCE_REUTERS_HITS``; ``DeviceField.with_position_data`` against the
JAX property on segments with and without positions, before and after
``ensure_positions``."""

import ast
from pathlib import Path

import numpy as np
import pytest

from diagon_tpu.bench import queries as jqueries
from diagon_tpu.document import Document, StringField, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.search import bm25 as jbm25
from diagon_tpu.search.device_index import load_segment as jax_load
from diagon_tpu_torch.bench import queries as pqueries
from diagon_tpu_torch.search import bm25 as pbm25
from diagon_tpu_torch.search.convert import query_from_jax, segment_from_jax
from diagon_tpu_torch.search.device_index import load_segment

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ["", "search", "codecs", "bench"]


def _exports(pkg_dir: Path):
    """Names an ``__init__.py`` binds at its top level, a ``try`` body
    included: its imports, assignments, functions and classes."""
    tree = ast.parse((pkg_dir / "__init__.py").read_text())
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in node.names)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Try):
                visit(node.body)

    visit(tree.body)
    return names


@pytest.mark.parametrize("pkg", PACKAGES)
def test_init_exports_equal(pkg):
    want = _exports(ROOT / "diagon_tpu" / pkg)
    got = _exports(ROOT / "diagon_tpu_torch" / pkg)
    assert want, f"diagon_tpu/{pkg} exports nothing"
    assert got == want, (f"{pkg or 'root'}: missing {sorted(want - got)}, "
                         f"extra {sorted(got - want)}")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_exported_names_resolve(pkg):
    """Every name the port's ``__init__`` exports is an attribute of the
    imported package."""
    import importlib

    mod = importlib.import_module(
        "diagon_tpu_torch" + (f".{pkg}" if pkg else ""))
    for name in _exports(ROOT / "diagon_tpu_torch" / pkg):
        assert hasattr(mod, name), name


def test_bm25_params_equal():
    got, want = pbm25.BM25Params(), jbm25.BM25Params()
    assert (got.k1, got.b) == (want.k1, want.b) == (1.2, 0.75)
    with pytest.raises(AttributeError):
        got.k1 = 2.0  # frozen, as the JAX dataclass
    assert pbm25.BM25Params(k1=0.9).k1 == jbm25.BM25Params(k1=0.9).k1


def _shape(q):
    """A query's structure, for comparing queries of the two packages."""
    kind = type(q).__name__
    if kind == "TermQuery":
        return (kind, q.term.field, q.term.text, q.boost)
    if kind == "PhraseQuery":
        return (kind, q.field, tuple(q.terms), q.boost)
    assert kind == "BooleanQuery", kind
    return (kind, q.minimum_number_should_match, q.boost,
            tuple((c.occur.value, _shape(c.query)) for c in q.clauses))


def test_reuters_queries_equal():
    got, want = pqueries.REUTERS_QUERIES, jqueries.REUTERS_QUERIES
    assert list(got) == list(want)
    for name in want:
        assert _shape(got[name]) == _shape(query_from_jax(want[name])), name
    assert {n: _shape(q) for n, q in pqueries.reuters_queries().items()} == {
        n: _shape(q) for n, q in got.items()}


def test_reference_reuters_hits_equal():
    assert pqueries.REFERENCE_REUTERS_HITS == jqueries.REFERENCE_REUTERS_HITS
    assert set(pqueries.REFERENCE_REUTERS_HITS) <= set(pqueries.REUTERS_QUERIES)


@pytest.fixture(scope="module")
def segments():
    """One 40-doc segment: ``body`` with positions, ``tag`` keywords
    (docs and freqs only)."""
    rng = np.random.default_rng(5)
    words = np.asarray(["oil", "price", "trade", "w1", "w2"], dtype=object)
    mem = MemoryIndex()
    for i in range(40):
        mem.add_document(
            Document()
            .add(TextField("body", " ".join(rng.choice(words, size=6))))
            .add(StringField("tag", f"t{i % 3}")))
    return flush_memory_index(mem, "_0")


@pytest.mark.parametrize("field", ["body", "tag"])
def test_with_position_data_equals_jax(segments, field):
    jf = jax_load(segments).fields[field]
    pf = load_segment(segment_from_jax(segments), "cpu").fields[field]
    assert pf.with_position_data == jf.with_position_data
    assert pf.with_position_data == (field == "body")
    assert pf.pos_start is None  # the property uploads nothing
    jf.ensure_positions()
    pf.ensure_positions()
    assert pf.with_position_data == jf.with_position_data
    assert (pf.pos_start is not None) == (field == "body")
