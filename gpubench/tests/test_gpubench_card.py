"""Each cell run briefly on the card, as the benchmark runs it: one
process a run, the result line checked. ``python -m pytest
gpubench/tests -m cuda`` on a machine with the card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name, trace):
    res = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", name, "--seed",
         str(2**31 + 101), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert r["device"]["busy_s"] > 0 and r["breakdown"]["device_ops"]
