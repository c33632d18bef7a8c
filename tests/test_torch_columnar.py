"""The port's columnar device engine (``diagon_tpu_torch.columnar``) against
the JAX package's ``DeviceTable`` and a numpy scan, on the CPU.

Tables are made from seeds with numpy and built into both packages from the
same arrays. Small granules (256 and 512 rows) give enough granules for
both of X1's branches: a sorted column and a narrow range keep at most
``cap`` granules (the pruned scan), an unsorted column or a wide range more
(the full scan). Tolerances, with ``host_fast=False``:

- count, min, max and granules_scanned bit-equal;
- an int sum bit-equal where each plane's total over the matching rows is
  below 2^24 (every f32 sum in the JAX program is then exact), else
  within relative 1e-6 (the JAX program sums the planes' granule totals in
  f32; the port rounds their exact total once);
- an f32 sum within relative 1e-5 (the JAX program sums in f32, the port in
  f64 rounded once);
- group counts exact, group sums within relative 1e-5.

The host BULK path (``host_fast_agg``) is numpy in both packages and must
match exactly. The cases of ``tests/unit/test_columnar.py`` that drive the
device table are mirrored on the port's own classes.
"""

import numpy as np
import pytest
import torch

import diagon_tpu.columnar as jcol
import diagon_tpu_torch.columnar as tcol
from diagon_tpu_torch.columnar import (
    ColumnarTable,
    DeviceTable,
    Float64Column,
    Int64Column,
    StringColumn,
    column_from_values,
)
from diagon_tpu_torch.columnar.table import MinMaxIndex
from diagon_tpu_torch.ops import range_agg as ra


# ---------------------------------------------------------------------------
# Mirrors of tests/unit/test_columnar.py on the port's classes
# ---------------------------------------------------------------------------


def _table(n=20000, seed=3):
    rng = np.random.Generator(np.random.PCG64(seed))
    t = ColumnarTable()
    t.add_column("ts", Int64Column(np.sort(rng.integers(0, 1 << 20, n))))
    t.add_column("price", Float64Column(rng.random(n) * 100))
    t.add_column("group", Int64Column(rng.integers(0, 8, n)), minmax=False)
    t.add_column(
        "name",
        StringColumn([f"item{int(i)}" for i in rng.integers(0, 500, n)]),
        bloom=True,
    )
    return t


def test_columns_and_table_copies():
    c = Int64Column([3, 1, 4, 1, 5])
    c.insert(9)
    np.testing.assert_array_equal(
        c.filter(np.array([1, 0, 1, 0, 0, 1], bool)).values, [3, 4, 9])
    assert c.compare_at(0, 1, c) == 1
    s = StringColumn(["alpha", "b", ""])
    assert s[0] == b"alpha" and s[2] == b"" and len(s) == 3
    assert isinstance(column_from_values([1.5, 2.0]), Float64Column)
    mm = MinMaxIndex.build(np.arange(20000, dtype=np.int64), 8192)
    np.testing.assert_array_equal(mm.mins, [0, 8192, 16384])
    t = _table()
    assert t.num_granules == 3 and "name" in t.bloom


def test_device_range_agg_matches_numpy():
    t = _table()
    dt = DeviceTable(t, device="cpu")
    ts = t.columns["ts"].values
    price = t.columns["price"].values
    lo, hi = 100000, 600000
    got = dt.range_agg("ts", lo, hi, agg_col="price", host_fast=False)
    mask = (ts >= lo) & (ts <= hi)
    assert got["count"] == int(mask.sum())
    assert got["min"] == np.float32(price[mask].astype(np.float32).min())
    assert got["max"] == np.float32(price[mask].astype(np.float32).max())
    assert abs(got["sum"] - price[mask].sum()) / price[mask].sum() < 1e-3
    assert got["granules_scanned"] < got["granules_total"]
    empty = dt.range_agg("ts", 1 << 30, None, host_fast=False)
    assert empty["count"] == 0 and empty["min"] is None


def test_host_fast_agg_bulk_resolution():
    t = _table()
    dt = DeviceTable(t, device="cpu")
    ts = t.columns["ts"].values
    price = t.columns["price"].values
    lo, hi = 100000, 600000
    got = dt.host_fast_agg("ts", lo, hi, agg_col="price")
    assert got is not None and got["host_fast_path"]
    mask = (ts >= lo) & (ts <= hi)
    assert got["count"] == int(mask.sum())
    assert got["min"] == price[mask].min()
    assert got["max"] == price[mask].max()
    assert abs(got["sum"] - price[mask].sum(dtype=np.float64)) < 1e-6 * max(
        1.0, abs(price[mask].sum()))
    assert got["granules_scanned"] <= 2
    got = dt.host_fast_agg("ts", lo, hi)
    assert got["sum"] == float(ts[mask].sum(dtype=np.int64))
    got = dt.host_fast_agg("ts", -100, -1)
    assert got["count"] == 0 and got["min"] is None and got["sum"] == 0.0
    got = dt.host_fast_agg("ts", None, None)
    assert got["granules_scanned"] == 0 and got["count"] == t.num_rows
    assert got["min"] == float(ts.min()) and got["max"] == float(ts.max())
    out = dt.host_fast_agg("price", 200.0, 300.0)
    assert out["count"] == 0 and out["granules_scanned"] == 0
    assert dt.host_fast_agg("price", 20.0, 30.0, max_partial=1) is None
    mid = dt.host_fast_agg("price", 20.0, 30.0)
    pm = (price >= 20.0) & (price <= 30.0)
    assert mid["count"] == int(pm.sum()) and mid["min"] == price[pm].min()
    via = dt.range_agg("ts", lo, hi, agg_col="price")
    assert via.get("host_fast_path") is True
    assert via["count"] == int(mask.sum())


def test_device_group_agg_matches_numpy():
    t = _table()
    dt = DeviceTable(t, device="cpu")
    ts = t.columns["ts"].values
    grp = t.columns["group"].values
    price = t.columns["price"].values
    got = dt.range_group_agg("ts", "group", 8, lower=0, upper=500000,
                             agg_col="price")
    mask = (ts >= 0) & (ts <= 500000)
    for g in range(8):
        want = int((mask & (grp == g)).sum())
        assert int(got["group_counts"][g]) == want
        ws = price[mask & (grp == g)].sum()
        if want:
            assert abs(float(got["group_sums"][g]) - ws) / max(ws, 1) < 1e-5


def test_device_string_predicates():
    t = _table()
    dt = DeviceTable(t, device="cpu")
    names = np.array([t.columns["name"][i] for i in range(t.num_rows)],
                     dtype=object)
    ts = t.columns["ts"].values
    price = t.columns["price"].values
    got = dt.range_agg("name", "item42", "item42", agg_col="price")
    mask = names == b"item42"
    assert got["count"] == int(mask.sum())
    assert got["min"] == np.float32(price[mask].astype(np.float32).min())
    got = dt.range_agg("name", "item10", "item19~")
    mask = (names >= b"item10") & (names <= b"item19~")
    assert got["count"] == int(mask.sum())
    assert dt.range_agg("name", "zzz", "zzz")["count"] == 0
    assert dt.range_agg("name", "aaa", "aab")["count"] == 0
    got = dt.range_agg("ts", 0, 200000, agg_col="name")
    mask = ts <= 200000
    assert got["min"] == names[mask].min() and got["max"] == names[mask].max()
    assert got["sum"] is None and got["avg"] is None
    g = dt.range_group_agg("ts", "name", lower=0, upper=500000)
    mask = ts <= 500000
    want = {}
    for nm in names[mask]:
        want[nm] = want.get(nm, 0) + 1
    for li, lab in enumerate(g["group_labels"]):
        assert int(g["group_counts"][li]) == want.get(lab, 0), lab


# ---------------------------------------------------------------------------
# The port against the JAX DeviceTable
# ---------------------------------------------------------------------------


def _arrays(n, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    half = 1 << 47
    return {
        "ts": np.sort(rng.integers(0, 1 << 20, n)),
        "big": np.sort(rng.integers(-half, half - 1, n)),  # a 48-bit span
        "rnd": rng.integers(0, 1_000_000, n),
        "neg": rng.integers(-5000, 5000, n),
        "price": rng.random(n) * 100,
        "grp": rng.integers(0, 16, n),
        "grp2": rng.integers(100, 116, n),  # group ids past an offset
        "name": [f"k{int(i)}" for i in rng.integers(0, 60, n)],
        "gneg": rng.integers(-20, 12, n),  # group ids below zero
    }


def _build(mod, arr, granule_rows):
    t = mod.ColumnarTable(granule_rows=granule_rows)
    for name, v in arr.items():
        if name == "name":
            t.add_column(name, mod.StringColumn(v))
        elif name == "price":
            t.add_column(name, mod.Float64Column(v))
        else:
            t.add_column(name, mod.Int64Column(v),
                         minmax=not name.startswith("grp"))
    return t


@pytest.fixture(scope="module", params=[(5000, 256, 1), (7777, 512, 2)],
            ids=["5000x256", "7777x512"])
def tables(request):
    """(arrays, port DeviceTable, JAX DeviceTable); neither table ends on a
    granule boundary."""
    n, gr, seed = request.param
    arr = _arrays(n, seed)
    assert n % gr
    port = DeviceTable(_build(tcol, arr, gr), device="cpu")
    jax_t = jcol.DeviceTable(_build(jcol, arr, gr))
    return arr, port, jax_t


QUERIES = [
    ("ts", 1000, 30000, None),  # sorted, narrow: pruned
    ("ts", 1000, 30000, "price"),
    ("ts", 0, 1 << 19, "rnd"),  # sorted, wide: full
    ("rnd", 100, 200000, "price"),  # unsorted: full
    ("rnd", None, None, "rnd"),  # every row; plane totals beyond 2^24
    ("big", -(1 << 40), 1 << 40, "big"),  # 48-bit values
    ("big", -(1 << 46), -(1 << 45), "neg"),
    ("ts", 1 << 30, None, None),  # empty: above every value
    ("ts", -100, -1, "price"),  # empty: below the offset
    ("price", 20.0, 30.0, "ts"),  # f32 filter
    ("price", None, None, "big"),
    ("neg", -100, 100, "neg"),  # negative offset
    ("name", "k1", "k3", "price"),  # dictionary codes
    ("ts", 0, 1 << 21, "name"),  # string aggregate
]


def _mask(arr, col, lo, hi):
    v = np.asarray(arr[col], dtype=object if col == "name" else None)
    m = np.ones(len(v), bool)
    if col == "name":
        v = np.asarray([s.encode() for s in arr[col]], dtype=object)
        lo = None if lo is None else lo.encode()
        hi = None if hi is None else hi.encode()
    if lo is not None:
        m &= v >= lo
    if hi is not None:
        m &= v <= hi
    return m


def _plane_totals(values, mask):
    u = (values[mask].astype(np.int64) - values.min()).astype(np.uint64)
    return [int(((u >> np.uint64(16 * i)) & np.uint64(0xFFFF)).sum())
            for i in range(3)]


def _assert_fused(got, want, sum_rtol, what):
    """Bit-equal lanes but the sum; the sum bit-equal too when ``sum_rtol``
    is None, else within it."""
    gb, wb = got.view(np.uint32), want.view(np.uint32)
    for i in (0, 1, 3, 4, 5):  # count lanes, min, max, granules scanned
        assert gb[i] == wb[i], (what, i, got, want)
    if sum_rtol is None:
        assert gb[2] == wb[2], (what, got, want)
    else:
        assert abs(float(got[2]) - float(want[2])) <= sum_rtol * abs(
            float(want[2])), (what, got, want)


@pytest.mark.parametrize("q", QUERIES, ids=lambda q: f"{q[0]}-{q[3]}-{q[1]}")
def test_range_agg_equals_jax(tables, q):
    arr, port, jax_t = tables
    col, lo, hi, agg = q
    got = port.dispatch_range_agg(col, lo, hi, agg).numpy()
    want = np.asarray(jax_t.dispatch_range_agg(col, lo, hi, agg))
    agg_name = agg or col
    m = _mask(arr, col, lo, hi)
    if agg_name in port.dicts:
        rtol = None  # string aggregates: the sum lane is unused
    elif port.is_int[agg_name]:
        exact = max(_plane_totals(np.asarray(arr[agg_name]), m)) < 1 << 24
        rtol = None if exact else 1e-6
    else:
        rtol = 1e-5
    _assert_fused(got, want, rtol, q)
    assert port.range_agg(col, lo, hi, agg, host_fast=False)["count"] == \
        int(m.sum())


def test_both_branches_and_scanned_granules(tables):
    """The queries force both branches: some keep at most cap granules, some
    more; granules_scanned is the count of kept granules either way."""
    _, port, _ = tables
    kept = [port.dispatch_range_agg(c, lo, hi, a).numpy()[5]
            for c, lo, hi, a in QUERIES]
    assert any(0 < k <= port.cap for k in kept)
    assert any(k > port.cap for k in kept)
    assert 0 in kept


@pytest.mark.parametrize("q", QUERIES, ids=lambda q: f"{q[0]}-{q[3]}-{q[1]}")
def test_host_fast_agg_equals_jax(tables, q):
    _, port, jax_t = tables
    col, lo, hi, agg = q
    for mp in (0, 4, 10_000):
        assert port.host_fast_agg(col, lo, hi, agg, max_partial=mp) == \
            jax_t.host_fast_agg(col, lo, hi, agg, max_partial=mp), (q, mp)


@pytest.mark.parametrize("spec", [
    ("ts", "grp", 16, 1000, 40000, "price"),  # pruned
    ("rnd", "grp", 16, 0, 900000, "rnd"),  # full, int aggregate
    ("ts", "grp", 9, None, None, "neg"),  # ids 9-15 dropped
    ("ts", "grp2", 120, 0, 1 << 19, "price"),  # ids = low plane + offset
    ("ts", "name", None, 0, 1 << 19, "price"),  # dictionary codes
    # -1 to the cut-off slot, -2..-17 wrap to 15..0, -18..-20 dropped
    ("ts", "gneg", 16, 0, 1 << 19, "price"),
], ids=lambda s: f"{s[0]}-{s[1]}-{s[2]}")
def test_group_agg_equals_jax(tables, spec):
    arr, port, jax_t = tables
    col, gcol, ng, lo, hi, agg = spec
    got = port.range_group_agg(col, gcol, ng, lo, hi, agg)
    want = jax_t.range_group_agg(col, gcol, ng, lo, hi, agg)
    assert got["count"] == want["count"]
    assert got["granules_scanned"] == want["granules_scanned"]
    np.testing.assert_array_equal(got["group_counts"],
                                  np.asarray(want["group_counts"]))
    np.testing.assert_allclose(got["group_sums"],
                               np.asarray(want["group_sums"], np.float64),
                               rtol=1e-5, atol=0)
    m = _mask(arr, col, lo, hi)
    if gcol == "name":
        ids = np.unique(arr["name"], return_inverse=True)[1]
        ng = int(ids.max()) + 1
    else:
        ids = np.asarray(arr[gcol])
    ids = _jax_slots(ids, ng)
    want_cnt = np.bincount(ids[m & (ids >= 0)], minlength=ng)[:ng]
    np.testing.assert_array_equal(got["group_counts"], want_cnt)


def _jax_slots(ids, ng):
    """numpy twin of the JAX scatter's index rule (num_groups + 1 slots,
    mode "drop", the last cut off): -1 where a row adds to no group."""
    ids = np.where((ids >= -(ng + 1)) & (ids <= -2), ids + ng + 1, ids)
    return np.where((ids >= 0) & (ids < ng), ids, -1)


@pytest.mark.parametrize("N", [1, 2, 5, 16])
def test_group_block_wraps_ids_as_the_jax_scatter(N):
    """The plain ``_group_block`` against JAX's own scatter into N + 1
    slots with mode "drop", ids -(N+2)..N+1: counts bit-equal, sums within
    f32 rounding (f64 sums rounded once against f32 adds)."""
    import jax.numpy as jnp

    ids = np.arange(-(N + 2), N + 2, dtype=np.int32)
    vals = np.random.default_rng(N).random(len(ids)).astype(np.float32)
    want_cnt = np.asarray(
        jnp.zeros(N + 1).at[ids].add(1.0, mode="drop")[:N])
    want_sum = np.asarray(
        jnp.zeros(N + 1).at[ids].add(jnp.asarray(vals), mode="drop")[:N])
    rmask = torch.ones(len(ids), dtype=torch.bool)
    cnt, s = ra._group_block(rmask, torch.from_numpy(ids),
                             (torch.from_numpy(vals),), False, N)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    np.testing.assert_allclose(s.numpy(), want_sum, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        ra.group_slots(torch.from_numpy(ids), N).numpy(), _jax_slots(ids, N))


def test_wrapper_counts_nothing_on_the_cpu(tables):
    _, port, _ = tables
    before = ra.range_agg.launches
    port.dispatch_range_agg("ts", 0, 5000)
    assert ra.range_agg.launches == before


def test_kernel_checks_refuse_what_it_does_not_take():
    """The wrapper's checks (run before every launch): granule rows a
    multiple of 4, cap within [1, G], planes of the column's kind."""
    G, R = 3, 8
    i = torch.zeros((G, R), dtype=torch.int32)
    f = torch.zeros((G, R), dtype=torch.float32)
    gi = torch.zeros(G, dtype=torch.int32)
    valid = torch.ones((G, R), dtype=torch.bool)
    ok = dict(filt_is_int=True, agg_is_int=False, num_groups=0, cap=2)
    assert ra._check((i, i, i), (f,), valid, (gi,) * 3, (gi,) * 3, None,
                     **ok) == (G, R)
    bad = [
        ((i, i, i), (f,), valid[:, :6], (gi,) * 3, (gi,) * 3, None, ok),
        ((i, i, i), (f,), valid, (gi,) * 3, (gi,) * 3, None,
         dict(ok, cap=4)),
        ((f,), (f,), valid, (gi,) * 3, (gi,) * 3, None, ok),
        ((i, i, i), (i, i, i), valid, (gi,) * 3, (gi,) * 3, None, ok),
        ((i, i, i), (f,), valid.int(), (gi,) * 3, (gi,) * 3, None, ok),
        ((i, i, i), (f,), valid, (gi,) * 3, (gi,) * 3, f,
         dict(ok, num_groups=4)),
    ]
    for *args, kw in bad:
        with pytest.raises(ValueError):
            ra._check(*args, **kw)


# ---------------------------------------------------------------------------
# NaN in a float column, and granule sizes that are not a multiple of 4
# ---------------------------------------------------------------------------


def _nan_table(mod, granule_rows):
    """4,096 rows: a sorted int key ``k``, float ``v`` (minmax) and ``w``
    (the same values, minmax on the device) with NaN at rows 100, 1500 and
    1501, and group ids ``g`` in [0, 8)."""
    rng = np.random.Generator(np.random.PCG64(9))
    n = 4096
    v = rng.random(n)
    v[[100, 1500, 1501]] = np.nan
    t = mod.ColumnarTable(granule_rows=granule_rows)
    t.add_column("k", mod.Int64Column(np.arange(n)))
    t.add_column("v", mod.Float64Column(v))
    t.add_column("w", mod.Float64Column(v.copy()), minmax=False)
    t.add_column("g", mod.Int64Column(rng.integers(0, 8, n)), minmax=False)
    return t


NAN_QUERIES = [
    ("k", 0, 3000, "v"),  # NaN rows among the aggregate's: full scan
    ("k", 90, 110, "v"),  # one NaN row: pruned scan
    ("k", 2000, 4000, "v"),  # no NaN row
    ("k", None, None, "w"),
    ("v", 0.25, 0.75, "k"),  # NaN filter values; NaN granules skipped
    ("w", 0.25, 0.75, "k"),  # the same, minmax from the device planes
    ("v", None, None, "v"),
]


def _assert_fused_nan(got, want, what):
    """Count lanes and granules bit-equal; sum, min and max both NaN or
    equal (the sum within relative 1e-5: f64 rounded once against f32)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for i in (0, 1, 5):
        assert got.view(np.uint32)[i] == want.view(np.uint32)[i], (what, i)
    for i in (2, 3, 4):
        g, w = float(got[i]), float(want[i])
        if np.isnan(w) or np.isnan(g):
            assert np.isnan(g) and np.isnan(w), (what, i, got, want)
        elif i == 2:
            assert abs(g - w) <= 1e-5 * abs(w), (what, got, want)
        else:
            assert got.view(np.uint32)[i] == want.view(np.uint32)[i], (
                what, i, got, want)


@pytest.fixture(scope="module", params=[256, 10])
def nan_tables(request):
    gr = request.param
    return (DeviceTable(_nan_table(tcol, gr), device="cpu"),
            jcol.DeviceTable(_nan_table(jcol, gr)))


@pytest.mark.parametrize("q", NAN_QUERIES,
                         ids=lambda q: f"{q[0]}-{q[3]}-{q[1]}")
def test_nan_float_column_equals_jax(nan_tables, q):
    """A NaN among the aggregate's rows makes min, max and sum NaN, as in
    the JAX package; a NaN filter value fails the range test, and a granule
    whose minmax is NaN is skipped, as the JAX package skips it."""
    port, jax_t = nan_tables
    col, lo, hi, agg = q
    got = port.dispatch_range_agg(col, lo, hi, agg).numpy()
    want = np.asarray(jax_t.dispatch_range_agg(col, lo, hi, agg))
    _assert_fused_nan(got, want, q)


def test_nan_rows_in_a_group_equal_jax(nan_tables):
    """The f64 group sums carry a NaN row's NaN into its group only."""
    port, jax_t = nan_tables
    got = port.range_group_agg("k", "g", 8, 0, 3000, "v")
    want = jax_t.range_group_agg("k", "g", 8, 0, 3000, "v")
    assert got["count"] == want["count"]
    np.testing.assert_array_equal(got["group_counts"],
                                  np.asarray(want["group_counts"]))
    ws = np.asarray(want["group_sums"], np.float64)
    assert np.isnan(ws).any()
    np.testing.assert_array_equal(np.isnan(got["group_sums"]), np.isnan(ws))
    np.testing.assert_allclose(got["group_sums"][~np.isnan(ws)],
                               ws[~np.isnan(ws)], rtol=1e-5, atol=0)


@pytest.fixture(scope="module", params=[(1000, 10, 7), (2003, 7, 8),
                                        (999, 3, 9)],
                ids=["1000x10", "2003x7", "999x3"])
def odd_tables(request):
    """(arrays, port DeviceTable, JAX DeviceTable) at granule sizes that
    are not a multiple of 4."""
    n, gr, seed = request.param
    arr = _arrays(n, seed)
    return (arr, DeviceTable(_build(tcol, arr, gr), device="cpu"),
            jcol.DeviceTable(_build(jcol, arr, gr)))


def test_granule_rows_10_answers_as_jax():
    """``range_agg("k", 5, 500)`` over 1,000 rows in granules of 10: count
    496, sum 125,240, min 5, max 500 over 51 of 100 granules, in both
    packages; the port's planes are padded to 12 rows a granule."""
    def table(mod):
        t = mod.ColumnarTable(granule_rows=10)
        t.add_column("k", mod.Int64Column(np.arange(1000)))
        return t

    port = DeviceTable(table(tcol), device="cpu")
    assert port.width == 12 and tuple(port.valid.shape) == (100, 12)
    got = port.range_agg("k", 5, 500, host_fast=False)
    want = jcol.DeviceTable(table(jcol)).range_agg("k", 5, 500,
                                                   host_fast=False)
    assert got == want
    assert (got["count"], got["sum"], got["min"], got["max"],
            got["granules_scanned"]) == (496, 125240.0, 5.0, 500.0, 51)


@pytest.mark.parametrize("q", QUERIES, ids=lambda q: f"{q[0]}-{q[3]}-{q[1]}")
def test_odd_granule_rows_equal_jax(odd_tables, q):
    arr, port, jax_t = odd_tables
    col, lo, hi, agg = q
    got = port.dispatch_range_agg(col, lo, hi, agg).numpy()
    want = np.asarray(jax_t.dispatch_range_agg(col, lo, hi, agg))
    agg_name = agg or col
    if agg_name in port.dicts:
        rtol = None
    elif port.is_int[agg_name]:
        m = _mask(arr, col, lo, hi)
        exact = max(_plane_totals(np.asarray(arr[agg_name]), m)) < 1 << 24
        rtol = None if exact else 1e-6
    else:
        rtol = 1e-5
    _assert_fused(got, want, rtol, q)


@pytest.mark.parametrize("spec", [
    ("ts", "grp", 16, 1000, 40000, "price"),
    ("rnd", "gneg", 16, 0, 900000, "rnd"),
], ids=lambda s: f"{s[0]}-{s[1]}")
def test_odd_granule_rows_group_agg_equals_jax(odd_tables, spec):
    _, port, jax_t = odd_tables
    col, gcol, ng, lo, hi, agg = spec
    got = port.range_group_agg(col, gcol, ng, lo, hi, agg)
    want = jax_t.range_group_agg(col, gcol, ng, lo, hi, agg)
    assert (got["count"], got["granules_scanned"]) == (
        want["count"], want["granules_scanned"])
    np.testing.assert_array_equal(got["group_counts"],
                                  np.asarray(want["group_counts"]))
    np.testing.assert_allclose(got["group_sums"],
                               np.asarray(want["group_sums"], np.float64),
                               rtol=1e-5, atol=0)


def test_the_cpu_plan_makes_the_kernels_checks():
    """A plan on CPU tensors refuses what a plan on the card refuses, so
    the plain version cannot take a shape the kernel does not."""
    G, R = 3, 6
    i = torch.zeros((G, R), dtype=torch.int32)
    gi = torch.zeros(G, dtype=torch.int32)
    valid = torch.ones((G, R), dtype=torch.bool)
    with pytest.raises(ValueError):
        ra.RangeAggPlan((i, i, i), (i, i, i), valid, (gi,) * 3, (gi,) * 3,
                        cap=1, filt_is_int=True, agg_is_int=True)


@pytest.mark.cuda
def test_kernel_equals_plain_on_nan_and_odd_granules_on_the_card():
    """X1 against its plain version on the NaN table (granules of 256 and
    10) and on tables at granule sizes 10, 7 and 3: NaN lanes both NaN,
    the rest as ``test_kernel_equals_plain_on_the_card`` holds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for gr in (256, 10):
        t = _nan_table(tcol, gr)
        cpu, gpu = DeviceTable(t, device="cpu"), DeviceTable(t, device="cuda")
        for col, lo, hi, agg in NAN_QUERIES:
            _assert_fused_nan(
                gpu.dispatch_range_agg(col, lo, hi, agg).cpu().numpy(),
                cpu.dispatch_range_agg(col, lo, hi, agg).numpy(),
                (gr, col, agg))
    arr = _arrays(3001, 10)
    for gr in (10, 7, 3):
        t = _build(tcol, arr, gr)
        cpu, gpu = DeviceTable(t, device="cpu"), DeviceTable(t, device="cuda")
        for col, lo, hi, agg in QUERIES:
            a = cpu.dispatch_range_agg(col, lo, hi, agg).numpy()
            b = gpu.dispatch_range_agg(col, lo, hi, agg).cpu().numpy()
            assert np.array_equal(np.delete(a, 2).view(np.uint32),
                                  np.delete(b, 2).view(np.uint32))
            assert abs(a[2] - b[2]) <= 1e-5 * abs(a[2])


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    """X1 on the card against its plain version (the chip run's check in
    small): counts, min, max, int sums and granules bit-equal, f32 sums
    within relative 1e-5, groups as above; at 18 granules and at 2,250
    (more than one compaction window of 2,048), with groups in the shared
    table (16) and past it (5,000, global adds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arr = _arrays(9000, 4)
    for granule_rows in (512, 4):
        t = _build(tcol, arr, granule_rows)
        cpu, gpu = DeviceTable(t, device="cpu"), DeviceTable(t, device="cuda")
        for col, lo, hi, agg in QUERIES:
            a = cpu.dispatch_range_agg(col, lo, hi, agg).numpy()
            b = gpu.dispatch_range_agg(col, lo, hi, agg).cpu().numpy()
            assert np.array_equal(np.delete(a, 2).view(np.uint32),
                                  np.delete(b, 2).view(np.uint32))
            assert abs(a[2] - b[2]) <= 1e-5 * abs(a[2])
        # group ids below zero: wrapped as the JAX scatter does
        for ng in (16, 5000):
            (a, (ac, asum)) = cpu.dispatch_range_group_agg(
                "ts", "gneg", ng, 0, 1 << 19, "price")
            (b, (bc, bsum)) = gpu.dispatch_range_group_agg(
                "ts", "gneg", ng, 0, 1 << 19, "price")
            assert np.array_equal(a.numpy()[[0, 1, 5]],
                                  b.cpu().numpy()[[0, 1, 5]])
            assert np.array_equal(ac.numpy(), bc.cpu().numpy())
            np.testing.assert_allclose(bsum.cpu().numpy(), asum.numpy(),
                                       rtol=1e-5, atol=0)
