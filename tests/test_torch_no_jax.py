"""diagon_tpu_torch imports with JAX and the JAX package unavailable, no
module of it (nor chip_smoke.py, nor chip_ab.py) imports either, and
chip_smoke.py refuses to run without a CUDA card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "diagon_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PACKAGE.rglob("*.py")
)

_PROBE = """
import importlib, json, sys
# any import of jax, or of the JAX package, now raises ImportError
sys.modules["jax"] = None
sys.modules["diagon_tpu"] = None
out = {}
for name in sys.argv[1:]:
    try:
        importlib.import_module(name)
        out[name] = "ok"
    except Exception as e:
        out[name] = f"{type(e).__name__}: {e}"
jaxlike = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "diagon_tpu")
                 if sys.modules[m] is not None)
print(json.dumps({"imports": out, "jax_modules": jaxlike}))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, *MODULES],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_every_module_is_probed():
    assert "diagon_tpu_torch" in MODULES
    for name in ("row_sum", "approx_pass", "gather_rescore", "bits_hits",
                 "range_agg"):
        assert f"diagon_tpu_torch.ops.{name}" in MODULES
    for name in ("search.query", "search.oracle", "index.segment",
                 "codecs.postings", "observability.metrics", "bench.bulk_build",
                 "native", "columnar.engine", "columnar.table",
                 "bench.columnar"):
        assert f"diagon_tpu_torch.{name}" in MODULES
    assert len(MODULES) >= 25


DISK_MODULES = ["store", "store.directory", "store.lock", "store.format",
                "index", "index.reader", "index.writer", "codecs.bitpack",
                "codecs.registry", "columnar.compression", "columnar.store",
                "columnar.parts"]


@pytest.mark.parametrize("name", DISK_MODULES)
def test_the_disk_modules_are_scanned_and_probed(probe, name):
    """The store tier, the index reader and the columnar host I/O are in
    both checks: the import probe and the source scans."""
    module = f"diagon_tpu_torch.{name}"
    assert module in MODULES
    assert probe["imports"][module] == "ok", probe["imports"][module]


WRITE_MODULES = ["analysis", "analysis.tokenizers", "analysis.filters",
                 "analysis.analyzer", "document", "document.document",
                 "document.mapping", "document.json_parser",
                 "index.field_infos", "index.memory_index", "index.merge",
                 "index.writer", "bench.synthetic", "entry"]


@pytest.mark.parametrize("name", WRITE_MODULES)
def test_the_write_path_modules_are_scanned_and_probed(probe, name):
    """The write path (documents, analysis, MemoryIndex, merges, the
    writer) and the entry() twin are in both checks."""
    module = f"diagon_tpu_torch.{name}"
    assert module in MODULES
    assert probe["imports"][module] == "ok", probe["imports"][module]


@pytest.mark.parametrize("first", ["diagon_tpu_torch.document",
                                   "diagon_tpu_torch.index.writer",
                                   "diagon_tpu_torch.store"])
def test_write_path_imports_in_any_order(first):
    """The document model takes its DocValuesType from index.segment; the
    index package loads its writer side lazily, so no first import closes
    a cycle, and the writer's names resolve from the package."""
    code = (f"import sys; sys.modules['jax'] = sys.modules['diagon_tpu'] = None\n"
            f"import {first}\n"
            "from diagon_tpu_torch.index import IndexWriter, MemoryIndex\n"
            "from diagon_tpu_torch.document import Document, DocValuesType\n"
            "from diagon_tpu_torch.index.segment import DocValuesType as S\n"
            "assert DocValuesType is S\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax(probe, module):
    assert probe["imports"][module] == "ok", probe["imports"][module]


def test_no_jax_module_loaded(probe):
    assert probe["jax_modules"] == []


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_never_imports_jax(path):
    for line in path.read_text().splitlines():
        words = line.split()
        assert words[:2] not in (["import", "jax"], ["from", "jax"]), line
        assert not (words[:1] == ["import"] and "jax." in line), line
        assert "diagon_tpu.ops" not in line and "diagon_tpu.parallel" not in line, line


def _imported_modules(path):
    """Every module an ``import`` or ``from`` statement of the file names,
    wherever the statement stands (docstrings, which cite JAX paths, are
    not imports)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                              ROOT / "chip_ab.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    names = _imported_modules(path)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "diagon_tpu")]
    assert not bad, bad


def test_import_check_sees_nested_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text('"""from diagon_tpu import x"""\nimport os\n\n\n'
                 "def g():\n    from diagon_tpu.search import query\n")
    assert _imported_modules(f) == ["os", "diagon_tpu.search"]


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=cwd, env=env, timeout=300,
    )


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
