"""The port's durable bench cache (``diagon_tpu_torch/bench/cache.py``)
against the JAX package's: the same directory, under ``DIAGON_CACHE_DIR``
and by default, and the same lookups."""

import diagon_tpu.bench.cache as jcache
import diagon_tpu_torch.bench.cache as cache


def test_cache_dir_follows_the_variable(tmp_path, monkeypatch):
    monkeypatch.setenv("DIAGON_CACHE_DIR", str(tmp_path / "c"))
    assert cache.bench_cache_dir() == jcache.bench_cache_dir()
    assert cache.bench_cache_dir() == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()
    assert cache.cache_path("seg.bnd") == jcache.cache_path("seg.bnd")
    assert cache.find_cached("seg.bnd") is None
    (tmp_path / "c" / "seg.bnd").write_bytes(b"x")
    assert cache.find_cached("seg.bnd") == str(tmp_path / "c" / "seg.bnd")
    assert cache.find_cached("seg.bnd") == jcache.find_cached("seg.bnd")


def test_default_cache_is_the_repos(monkeypatch):
    monkeypatch.delenv("DIAGON_CACHE_DIR", raising=False)
    monkeypatch.setattr(cache.os, "makedirs", lambda *a, **k: None)
    monkeypatch.setattr(jcache.os, "makedirs", lambda *a, **k: None)
    assert cache.bench_cache_dir() == jcache.bench_cache_dir()
    assert cache.bench_cache_dir().endswith(".bench_cache")


def test_nothing_outside_the_cache_is_looked_in(tmp_path, monkeypatch):
    """The JAX module also looks in ~/.cache/diagon_tpu; the port looks
    only in its cache directory."""
    monkeypatch.setenv("DIAGON_CACHE_DIR", str(tmp_path / "c"))
    looked = []
    exists = cache.os.path.exists
    monkeypatch.setattr(cache.os.path, "exists",
                        lambda p: looked.append(p) or exists(p))
    assert cache.find_cached("old.bnd") is None
    names = [p for p in looked if p.endswith("old.bnd")]
    assert names == [str(tmp_path / "c" / "old.bnd")]
