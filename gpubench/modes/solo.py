"""A solo call: one query through ``search``."""

import time


def call(system, queries, k, trace, span, sync):
    """(start, dispatched, synced, end) host times and the answer."""
    (q,) = queries
    t0 = time.perf_counter()
    with span("search"):
        res = system.search(q, k)
    t1 = time.perf_counter()
    return (t0, t1, t1, t1), [res]
