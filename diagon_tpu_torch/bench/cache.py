"""Durable bench cache location: the port's copy of
``diagon_tpu/bench/cache.py``, the same directory and the same variable.

Expensive deterministic artifacts (scale segments, columnar tables, oracle
results) persist in an in-repo cache directory ``<repo>/.bench_cache``
(git ignored: nothing in it is source; everything is reproducible), or in
``$DIAGON_CACHE_DIR`` where that is set. ``bench_cache_dir()`` is the write
location and ``find_cached(name)`` looks there. The JAX module's second
lookup in ``~/.cache/diagon_tpu`` is not kept: the port reads and writes
nothing outside its checkout unless the variable names a place.
"""

from __future__ import annotations

import os


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def bench_cache_dir() -> str:
    """The durable cache directory (created on first use)."""
    d = os.environ.get("DIAGON_CACHE_DIR") or os.path.join(
        _repo_root(), ".bench_cache"
    )
    os.makedirs(d, exist_ok=True)
    return d


def find_cached(name: str) -> str | None:
    """Locate ``name`` (file or directory) in the cache. Returns None when
    absent."""
    p = os.path.join(bench_cache_dir(), name)
    return p if os.path.exists(p) else None


def cache_path(name: str) -> str:
    """Path for writing ``name`` into the durable cache."""
    return os.path.join(bench_cache_dir(), name)
