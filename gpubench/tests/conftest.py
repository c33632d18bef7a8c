"""The benchmark's own tests: ``python -m pytest gpubench/tests`` from the
root of the checkout. Cases marked ``cuda`` need the card and skip
without it."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    import torch

    # several test workers share the host's cores
    torch.set_num_threads(2)

    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skipped where there is none",
    )
