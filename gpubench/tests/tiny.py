"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds."""

import time

from harness import cell as cells

SEED = 2**31 + 977  # more than 32 signed bits hold


def tiny_cell(name: str, num_docs: int = 3000):
    c = cells.load_cell(name)
    c.config = dict(c.config, num_docs=num_docs)
    c.traffic = dict(c.traffic)
    if c.traffic["batch_size"] > 1:
        c.traffic.update(batch_size=64, pool_calls=4, warmup_calls=1,
                         kept_per_call=16)
    return c


def run(c, seed=SEED, seconds=1.0, trace=False, system_cls=None):
    return cells.execute(c, seed, seconds, trace, "cpu", time.time(),
                         system_cls=system_cls)
