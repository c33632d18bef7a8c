"""The plain reference against the program on the CPU (the kernels' plain
versions), its independence from the program, and the control that the
comparison has to reject."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from harness import check
from harness.corpus import make_corpus
from harness.system import System
from harness.traffic import make_pool
from reference import Reference
from tiny import SEED, tiny_cell

HERE = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in
         json.loads((HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


def _specs(cell, seed):
    corpus = make_corpus(cell.config, seed, "cpu")
    field = corpus.fields[cell.traffic["field"]]
    pool = make_pool(cell.traffic, seed)
    return corpus, field, [s for c in pool.calls for s in c]


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_program_on_cpu(name):
    """Every query of a tiny pool: the program's answer (plain versions
    of its kernels) is the reference's, bit for bit."""
    cell = tiny_cell(name)
    corpus, field, specs = _specs(cell, SEED)
    specs = specs[:200]
    ref = Reference(field.doc_len, field.tokens, field.vocab, "cpu")
    expected = ref.answer(specs, 10)
    system = System(corpus, "cpu")
    got = [System.answer(system.search(q, 10))
           for q in system.queries(specs, "body")]
    numbers = check.compare(got, expected, 0)
    assert numbers["wrong_answers"] == 0 and numbers["score_gap"] == 0.0
    assert sum(h for h, _, _ in expected) > 0


@pytest.mark.parametrize("seed", [SEED, 7, 2**31 + 12345])
@pytest.mark.parametrize("name", ["reuters-19k.table-b1024", "rcv1-804k.table-b1024"])
def test_bf16_control_is_rejected(name, seed):
    """The reference in bfloat16 put in the program's place fails the
    comparison (the control of the limits in harness/check.py)."""
    cell = tiny_cell(name)
    _, field, specs = _specs(cell, seed)
    specs = specs[:200]
    ref = Reference(field.doc_len, field.tokens, field.vocab, "cpu")
    numbers = check.compare(ref.answer(specs, 10, "bf16"),
                            ref.answer(specs, 10), 0)
    ok, _ = check.verdict(numbers)
    assert not ok
    assert numbers["wrong_answers"] > 0 and numbers["score_gap"] > 1e-3


def _documents(f):
    start = np.concatenate([[0], np.cumsum(f.doc_len)])
    return sorted(tuple(f.tokens[a:z]) for a, z in zip(start[:-1], start[1:]))


def test_corpus_follows_the_seed():
    """The same seed gives the same arrays; another seed the same
    documents in another order."""
    cell = tiny_cell("rcv1-804k.table-b1024", num_docs=500)
    a = make_corpus(cell.config, SEED, "cpu").fields["body"]
    b = make_corpus(cell.config, SEED, "cpu").fields["body"]
    c = make_corpus(cell.config, SEED + 1, "cpu").fields["body"]
    assert np.array_equal(a.tokens, b.tokens) and np.array_equal(a.doc_len, b.doc_len)
    assert not np.array_equal(a.doc_len, c.doc_len)
    assert _documents(a) == _documents(c)
    assert a.doc_len.min() >= cell.config["body_min_len"]
    assert len(a.vocab) == cell.config["vocab_size"]
    assert set(cell.config["planted_terms"]) <= set(a.vocab)


def test_phrases_are_injected():
    """About phrase_doc_share of the documents hold a planted phrase."""
    cell = tiny_cell("rcv1-804k.table-b1024", num_docs=4000)
    f = make_corpus(cell.config, SEED, "cpu").fields["body"]
    ref = Reference(f.doc_len, f.tokens, f.vocab, "cpu")
    hits = [ref.answer([("phrase", tuple(p))], 10)[0][0]
            for p in cell.config["injected_phrases"]]
    assert 0.04 * 4000 < sum(hits) < 0.2 * 4000


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    tops = {m.split(".")[0] for p in (HERE / "reference").glob("*.py")
            for m in _imports(p)}
    assert tops <= {"__future__", "typing", "numpy", "torch", "reference"}
    code = (
        "import sys; sys.path[:0] = [%r]; import reference; "
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'diagon_tpu', 'diagon_tpu_torch'}); "
        "print(bad); sys.exit(1 if bad else 0)" % str(HERE)
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=HERE.parent)
    assert res.returncode == 0, res.stdout + res.stderr


def test_control_script_rejects_without_the_program():
    """``control.py`` as it is run, in a process that cannot import the
    program: every seed comes out not correct."""
    res = subprocess.run(
        [sys.executable, "gpubench/control.py", "--workload",
         "reuters-19k.table-b1024", "--calls", "5", "--seeds", "3", "11",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=HERE.parent, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    rows = [json.loads(x) for x in res.stdout.splitlines()]
    assert len(rows) == 2 and not any(r["correct"] for r in rows)
