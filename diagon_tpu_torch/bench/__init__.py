"""Benchmark support: deterministic synthetic corpora and query sets (the
port's copy of ``diagon_tpu.bench``)."""

from diagon_tpu_torch.bench.queries import REUTERS_QUERIES  # noqa: F401
from diagon_tpu_torch.bench.synthetic import generate_reuters_like  # noqa: F401
