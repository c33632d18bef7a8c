"""The one generator of query traffic: reads a traffic file's parameters
and draws a seeded pool of calls, the order the window sends them in, and
which answers it keeps for the comparison.

A spec is ``("bool", must, should, must_not)`` (tuples of term texts) or
``("phrase", terms)``. A traffic file lists a ``table`` of specs and
cites its source. The table is sent in passes, each pass a permutation
of it, drawn from the traffic's ``pool_seed``, so every run sends the
same stream of queries, as a replayed log; a call takes the next
``batch_size`` specs of the stream. The pool holds ``pool_calls`` calls,
and warm-up ``warmup_calls`` calls of its own after them. The run's seed
orders the pool's calls and draws the answers kept: a call is kept with
probability ``kept_share``, and of a kept call ``kept_per_call``
positions. A traced run profiles at most ``stretch_calls`` calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

ORDER_LEN = 1 << 16  # calls before the order repeats


@dataclass
class Pool:
    mode: str  # the name of the call's shape: modes/<mode>.py
    k: int
    field: str
    calls: List[List[tuple]]  # a call: its specs
    warmup: List[List[tuple]]
    order: np.ndarray  # int64 [ORDER_LEN]: the pool call sent at call i
    keep: List[tuple]  # [ORDER_LEN]: the positions kept of call i
    stretch_calls: int  # the most calls the profiled stretch of a traced run holds


def _spec_from_entry(entry) -> tuple:
    if "phrase" in entry:
        return ("phrase", tuple(entry["phrase"]))
    return ("bool", tuple(entry.get("must", ())),
            tuple(entry.get("should", ())), tuple(entry.get("must_not", ())))


def _passes(rng, size: int, n: int) -> np.ndarray:
    reps = -(-n // size)
    return np.concatenate([rng.permutation(size) for _ in range(reps)])[:n]


def make_pool(traffic: dict, seed: int) -> Pool:
    table = [_spec_from_entry(e) for e in traffic["table"]]
    bs, n_pool, n_warm = (traffic["batch_size"], traffic["pool_calls"],
                          traffic["warmup_calls"])
    stream = _passes(np.random.Generator(np.random.PCG64(traffic["pool_seed"])),
                     len(table), bs * (n_pool + n_warm))
    chunks = [[table[i] for i in stream[c * bs:(c + 1) * bs]]
              for c in range(n_pool + n_warm)]

    rng = np.random.Generator(np.random.PCG64([seed % (1 << 63), 1]))
    order = _passes(rng, n_pool, ORDER_LEN)
    kept = rng.random(ORDER_LEN) < traffic["kept_share"]
    pos = rng.integers(0, bs, (ORDER_LEN, traffic["kept_per_call"]))
    keep = [tuple(sorted(set(p.tolist()))) if k else ()
            for k, p in zip(kept, pos)]
    return Pool(traffic["mode"], traffic["k"], traffic["field"],
                chunks[:n_pool], chunks[n_pool:], order, keep,
                traffic["stretch_calls"])
