"""The ClickBench-style table of ``benchmarks/columnar_bench.py``: the
port's own copy of its ``build_table`` (same columns, distributions and
seed, so the same table) and of its six queries.

A hits-like table: a sorted event time (the MergeTree ORDER BY, so
prunable), user, sorted counter and region ids, a screen width from six
values and a gamma-distributed duration.
"""

from __future__ import annotations

import numpy as np

from diagon_tpu_torch.columnar import ColumnarTable, Float64Column, Int64Column

# the reference's columnar trio (Q9/Q10/Q14) and the bench's own additions
QUERIES = {
    "q9_region_range": dict(filter_col="region", lower=200, upper=300),
    "q10_width_ge": dict(filter_col="res_width", lower=1900),
    "q14_counter_narrow": dict(filter_col="counter_id", lower=0, upper=100),
    "narrow_ts_agg": dict(
        filter_col="event_ts", lower=1 << 20, upper=(1 << 20) + (1 << 16),
        agg_col="duration",
    ),
    "wide_ts_agg": dict(
        filter_col="event_ts", lower=0, upper=1 << 21, agg_col="duration"
    ),
    "point_user": dict(filter_col="user_id", lower=777, upper=777),
}

# the bench's group-by: per region, over the wide event-time range
GROUP_QUERY = dict(filter_col="event_ts", group_col="region", num_groups=4096,
                   lower=0, upper=1 << 21, agg_col="duration")


def build_table(rows: int, seed: int = 11) -> ColumnarTable:
    rng = np.random.Generator(np.random.PCG64(seed))
    t = ColumnarTable()
    # event-time: sorted (the classic MergeTree ORDER BY) -> prunable
    t.add_column("event_ts", Int64Column(np.sort(rng.integers(0, 1 << 22, rows))))
    t.add_column("user_id", Int64Column(rng.integers(0, 100000, rows)), minmax=True)
    t.add_column("counter_id", Int64Column(np.sort(rng.integers(0, 1 << 17, rows))),
                 minmax=True)
    t.add_column("region", Int64Column(rng.integers(0, 4096, rows)), minmax=True)
    t.add_column("res_width", Int64Column(rng.choice(
        [1366, 1440, 1536, 1920, 2560, 3840], rows)), minmax=True)
    t.add_column("duration", Float64Column(rng.gamma(2.0, 150.0, rows)))
    return t
