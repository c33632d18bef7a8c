"""X1's launch plan (``diagon_tpu_torch.ops.range_agg.RangeAggPlan``) and
``DeviceTable``'s cache of plans, on the CPU: the packed argument block
agrees with ``struct X1Args`` in ``csrc/range_agg.cu``, a plan holds the
planes' own pointers, a table makes one plan per query shape, and host
threads sharing a plan each launch with their own bounds and output. None
of these launches a kernel."""

import ctypes
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from diagon_tpu_torch.columnar import (
    ColumnarTable,
    DeviceTable,
    Float64Column,
    Int64Column,
)
from diagon_tpu_torch.ops import launches
from diagon_tpu_torch.ops import range_agg as ra

CU = Path(ra.__file__).resolve().parents[1] / "csrc" / "range_agg.cu"


def _struct_fields(src):
    """Field names of ``struct X1Args`` in the kernel source, in order."""
    body = re.search(r"struct X1Args \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"//[^\n]*", "", decl).strip()
        if not decl:
            continue
        head, _, rest = decl.rpartition(" ")
        if "," in decl:  # "long long lo, hi"
            head, _, rest = decl.partition(",")
            names.append(head.split()[-1].lstrip("*"))
            names += [n.strip() for n in rest.split(",")]
        else:
            names.append(rest.lstrip("*"))
    return names


def test_args_size_equals_the_kernels_static_assert():
    src = CU.read_text()
    n = int(re.search(r"static_assert\(sizeof\(X1Args\) == (\d+)",
                      src).group(1))
    assert ctypes.sizeof(ra.X1Args) == n == ra.ARGS_BYTES


def test_args_fields_are_the_kernels_in_its_order():
    """Equal sizes alone would let two fields swap places: the names and
    their order must match too, every one 8 bytes."""
    want = _struct_fields(CU.read_text())
    assert [f[0] for f in ra.X1Args._fields_] == want
    assert all(ctypes.sizeof(t) == 8 for _, t in ra.X1Args._fields_)


def _table(n=3000, granule_rows=256, seed=7):
    rng = np.random.default_rng(seed)
    t = ColumnarTable(granule_rows=granule_rows)
    t.add_column("ts", Int64Column(np.sort(rng.integers(0, 1 << 20, n))))
    t.add_column("price", Float64Column(rng.random(n) * 100))
    t.add_column("grp", Int64Column(rng.integers(-3, 8, n)))
    return DeviceTable(t, device="cpu")


def _ptrs(planes):
    return [p.data_ptr() for p in planes] * (3 // len(planes))


@pytest.mark.parametrize("filt,agg", [("ts", None), ("ts", "price"),
                                      ("price", "ts"), ("price", None)])
def test_plan_points_at_the_planes(filt, agg):
    dt = _table()
    _, plan = dt._plan(filt, agg)
    a = plan.args
    gmin, gmax = dt._mm(filt)
    assert [a.f0, a.f1, a.f2] == _ptrs(dt.planes[filt])
    assert [a.a0, a.a1, a.a2] == _ptrs(dt.planes[agg or filt])
    assert [a.gmin0, a.gmin1, a.gmin2] == _ptrs(gmin)
    assert [a.gmax0, a.gmax1, a.gmax2] == _ptrs(gmax)
    assert a.valid == dt.valid.data_ptr()
    assert a.groups is None and a.num_groups == 0
    assert (a.G, a.R) == (dt.num_granules, dt.granule_rows)
    assert (a.filt_int, a.agg_int) == (dt.is_int[filt], dt.is_int[agg or filt])
    # a CPU plan runs the plain version: no grid, no scratch
    assert plan.grid == 0 and plan.scratch is None and a.parts is None


def test_group_plan_points_at_the_low_plane_and_its_offset():
    dt = _table()
    _, plan = dt._plan("ts", "price", "grp", 11)
    a = plan.args
    assert a.groups == dt.planes["grp"][0].data_ptr()
    assert a.goff == dt.offsets["grp"] == -3
    assert a.num_groups == 11


def test_bare_plan_from_cpu_tensors():
    """``range_agg`` called bare makes a plan from the tensors it is given;
    on the CPU it equals the plain version."""
    dt = _table()
    args, flags = dt._args("ts", 1000, 400000, "price")
    plan = ra.RangeAggPlan(*args[:5], **flags)
    assert plan.args.f0 == args[0][0].data_ptr()
    got = plan(args[5], args[6])
    want = ra.range_agg_reference(*args, **flags)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(ra.range_agg(*args, **flags).view(torch.int32),
                       want.view(torch.int32))


def test_same_query_shape_reuses_its_plan():
    dt = _table()
    a = dt.dispatch_range_agg("ts", 0, 5000, "price")
    key, plan = dt._plan("ts", "price")
    b = dt.dispatch_range_agg("ts", 900, 1 << 19, "price")  # other bounds
    assert dt._plan("ts", "price") == (key, plan)
    assert list(dt._plans) == [key]
    assert not torch.equal(a, b)


@pytest.mark.parametrize("other", [
    dict(agg_col="ts"),  # another aggregate column
    dict(agg_col=None),
    dict(filter_col="price"),  # another filter
    dict(group_col="grp", num_groups=8),
])
def test_another_query_shape_gets_another_plan(other):
    dt = _table()
    dt.dispatch_range_group_agg("ts", "grp", 4, 0, 1 << 19, "price")
    first = dict(dt._plans)
    q = dict(dict(filter_col="ts", agg_col="price", group_col="grp",
                  num_groups=4), **other)
    if "group_col" in other:
        dt.dispatch_range_group_agg(q["filter_col"], q["group_col"],
                                    q["num_groups"], 0, 1 << 19,
                                    q["agg_col"])
    else:
        dt.dispatch_range_agg(q["filter_col"], 0, 1 << 19, q["agg_col"])
    assert len(dt._plans) == 2
    new = [p for k, p in dt._plans.items() if k not in first]
    assert len(new) == 1 and new[0] is not next(iter(first.values()))


def test_scratch_words_hold_partials_ticket_and_groups():
    # 6 int64 words a block, the ticket, f64 sums and i32 counts
    assert ra.scratch_words(264, 0) == 6 * 264 + 1
    assert ra.scratch_words(264, 4096) == 6 * 264 + 1 + 4096 + 2048
    assert ra.scratch_words(1, 3) == 6 + 1 + 3 + 2


def test_threads_sharing_a_plan_launch_their_own_bounds_and_output():
    """Two host threads call one plan. The launcher (a ctypes callback in
    the library's place) reads its argument block only after both calls
    have filled theirs, so a block shared between calls would show one
    call the other's bounds or output."""
    dt = _table()
    _, plan = dt._plan("ts", "price")
    # the launch path on CPU tensors: the callback stands in for the card
    plan.scratch, plan.stream = torch.zeros(1, dtype=torch.int64), None
    both_filled = threading.Barrier(2, timeout=30)
    seen, made = {}, {}

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
    def launch(block, stream):
        both_filled.wait()
        a = ra.X1Args.from_address(block)
        seen[threading.get_ident()] = (a.lo, a.hi, a.out, a.f0, a.parts)
        return 0

    plan._launch = launch

    def call(lo, hi):
        blo, bhi = dt._bounds("ts", lo, hi)
        out = plan(blo, bhi)
        made[threading.get_ident()] = (ra._value48(blo), ra._value48(bhi),
                                       out)

    before = launches("range_agg")
    threads = [threading.Thread(target=call, args=b)
               for b in ((1000, 400000), (5000, 900000))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(seen) == len(made) == 2
    assert launches("range_agg") - before == 2  # one a call
    for ident, (lo, hi, out) in made.items():
        assert seen[ident] == (lo, hi, out.data_ptr(), plan.args.f0,
                               plan.args.parts)
    assert len({m[:2] for m in made.values()}) == 2
    # the plan's own block keeps no call's bounds or output
    assert plan.args.out is None and plan.args.lo == plan.args.hi == 0
