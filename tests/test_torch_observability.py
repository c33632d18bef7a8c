"""The port's observability against the JAX package's: the cases of
``tests/unit/test_observability.py`` (metrics, health, profiler) on both
packages with equal results, the device probe on ``torch.cuda`` (UNHEALTHY
for a CUDA device where there is none, never HEALTHY on the CPU in its
place), ``QueryProfiler.trace`` on ``torch.profiler``, and
``test_api_end_to_end.py::test_profiler_hooks`` through both APIs."""

import json
import time

import pytest
import torch

import diagon_tpu.api as jdg
import diagon_tpu.observability as jobs
import diagon_tpu_torch.api as dg
import diagon_tpu_torch.observability as tobs
from diagon_tpu_torch.observability import (
    HealthRegistry,
    HealthStatus,
    ProfileScope,
    QueryProfiler,
)
from diagon_tpu_torch.observability.health import device_health_check

BOTH = pytest.mark.parametrize("m", [tobs, jobs], ids=["port", "jax"])


def test_the_exports_are_the_jax_packages():
    names = {n for n in dir(jobs) if not n.startswith("_")
             and n not in ("metrics", "health", "profiler")}
    assert names <= set(dir(tobs)), names - set(dir(tobs))


@BOTH
def test_counter_gauge(m):
    c = m.Counter("c")
    c.increment()
    c.increment(5)
    assert c.value() == 6
    g = m.Gauge("g")
    g.set(2.5)
    g.add(0.5)
    assert g.value() == 3.0


def _histogram(m):
    h = m.Histogram("h", buckets=[1, 2, 4, 8])
    for v in [0.5, 1.5, 3, 3, 7, 100]:
        h.observe(v)
    return (h.count(), h.mean(), [h.percentile(p) for p in
                                  (0.0, 0.25, 0.5, 0.9, 1.0)])


def test_histogram_percentiles():
    got = _histogram(tobs)
    assert got == _histogram(jobs)
    count, mean, pct = got
    assert count == 6
    assert mean == sum([0.5, 1.5, 3, 3, 7, 100]) / 6
    assert pct[2] <= 4
    assert pct[4] == float("inf")


@BOTH
def test_timer_scoped(m):
    t = m.Timer("t", buckets=[0.0001, 0.01, 1])
    with t.time():
        time.sleep(0.001)
    assert t.count() == 1
    assert 0 < t.sum() < 1


@BOTH
def test_registry(m):
    r = m.MetricsRegistry()
    assert r.counter("x") is r.counter("x")
    r.gauge("y").set(5)
    snap = r.snapshot()
    assert snap["x"] == 0 and snap["y"] == 5
    with pytest.raises(TypeError):
        r.gauge("x")


def _health(m):
    hr = m.HealthRegistry()
    out = []
    hr.register("ok", lambda: m.HealthCheckResult("ok", m.HealthStatus.HEALTHY))
    out.append(hr.overall().value)
    hr.register("warn",
                lambda: m.HealthCheckResult("warn", m.HealthStatus.DEGRADED),
                critical=False)
    out.append(hr.overall().value)
    hr.register("boom", lambda: 1 / 0)
    out.append(hr.overall().value)
    out.append([(r.name, r.status.value, r.critical) for r in hr.run_all()])
    return out


def test_health():
    got = _health(tobs)
    assert got == _health(jobs)
    assert got[:3] == ["healthy", "degraded", "unhealthy"]


def test_device_health_check_names_the_device():
    r = device_health_check("cpu")
    assert r.status == HealthStatus.HEALTHY
    assert "cpu" in r.message


def test_device_health_check_never_reports_the_cpu_for_a_card():
    r = device_health_check("cuda")
    if torch.cuda.is_available():
        assert r.status == HealthStatus.HEALTHY
        assert torch.cuda.get_device_name(0) in r.message
    else:
        assert r.status == HealthStatus.UNHEALTHY
        assert "CUDA is not available" in r.message
    assert device_health_check().status == r.status
    hr = HealthRegistry()
    hr.register("device", device_health_check)
    assert hr.overall() == r.status


def _profile(m):
    p = m.QueryProfiler.enable()
    with m.ProfileScope("phase1"):
        time.sleep(0.001)
    with m.ProfileScope("phase1"):
        pass
    p.begin_phase("manual")
    p.end_phase("manual")
    rep = p.report()
    q = m.QueryProfiler(enabled=False)
    q.begin_phase("x")
    q.end_phase("x")
    return rep, q.report()


@BOTH
def test_query_profiler(m):
    rep, disabled = _profile(m)
    assert rep["phase1"]["count"] == 2
    assert rep["phase1"]["max_us"] >= 1000
    assert "manual" in rep
    assert disabled == {}


def test_profiler_is_thread_local_and_off_by_default():
    import threading

    QueryProfiler.enable()
    seen = []
    t = threading.Thread(target=lambda: seen.append(QueryProfiler.current()))
    t.start()
    t.join()
    assert not seen[0].enabled
    with ProfileScope("x", profiler=seen[0]):
        pass
    assert seen[0].report() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with QueryProfiler.trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    assert prof is not None


def test_trace_of_a_card_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with QueryProfiler.trace(str(tmp_path)):
            pass
    assert not (tmp_path / "trace.json").exists()


def _hooks(api, tmp_path, **kw):
    path = str(tmp_path)
    w = api.open_writer(path)
    api.add_document(w, {"body": "oil price"})
    api.commit(w)
    api.close_writer(w)
    s = api.open_searcher(api.open_reader(path), **kw)
    p = (tobs if api is dg else jobs).QueryProfiler.enable()
    hits = api.search(s, api.term_query("body", "oil"))
    api.search(s, api.phrase_query("body", ["oil", "price"]))
    return hits, {n: r["count"] for n, r in p.report().items()}


# the port's spans inside the row engine (the batch entry's light bank
# among them) and the answers, which the JAX package lacks: one each for a
# term search over one segment
PORT_SPANS = {"route": 1, "copy": 1, "finalize": 1, "topdocs": 1,
              "light": 1}


def test_profiler_hooks(tmp_path):
    """test_api_end_to_end.py::test_profiler_hooks, and a phrase: the JAX
    package's phases with the same counts in both packages, and the port's
    own spans with theirs."""
    hits, counts = _hooks(dg, tmp_path / "port", device="cpu")
    jhits, jcounts = _hooks(jdg, tmp_path / "jax")
    assert hits == jhits
    assert {n: c for n, c in counts.items() if n in jcounts} == jcounts
    assert jcounts == {"plan": 1, "execute": 1, "merge": 1, "phrase": 1}
    assert {n: c for n, c in counts.items() if n not in jcounts} == PORT_SPANS
    assert len(hits) == 1


def test_scopes_record_nothing_when_disabled(tmp_path):
    QueryProfiler.enable()
    p = QueryProfiler(enabled=False)
    QueryProfiler._tls.profiler = p
    w = dg.open_writer(str(tmp_path))
    dg.add_document(w, {"body": "oil"})
    dg.commit(w)
    dg.close_writer(w)
    s = dg.open_searcher(dg.open_reader(str(tmp_path)), device="cpu")
    dg.search(s, dg.term_query("body", "oil"))
    assert p.report() == {}


@pytest.mark.cuda
def test_trace_names_the_row_sum_kernel_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    w = dg.open_writer(str(tmp_path / "idx"))
    dg.add_document(w, {"body": "oil price"})
    dg.commit(w)
    dg.close_writer(w)
    s = dg.open_searcher(dg.open_reader(str(tmp_path / "idx")))
    with QueryProfiler.trace(str(tmp_path / "trace")):
        dg.search(s, dg.term_query("body", "oil"))
    assert "row_sum_kernel" in (tmp_path / "trace" / "trace.json").read_text()
