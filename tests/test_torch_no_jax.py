"""diagon_tpu_torch imports with JAX unavailable, and chip_smoke.py refuses
to run without a CUDA card."""

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
sys.modules["jax"] = None  # any import of jax now raises ImportError
out = {}
for name in sys.argv[1:]:
    try:
        importlib.import_module(name)
        out[name] = "ok"
    except Exception as e:
        out[name] = f"{type(e).__name__}: {e}"
jaxlike = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
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
    for name in ("row_sum", "approx_pass", "gather_rescore"):
        assert f"diagon_tpu_torch.ops.{name}" in MODULES
    assert len(MODULES) >= 12


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
