"""A batch call: ``dispatch`` launches the batch and returns without
waiting, ``collect`` brings every answer to the host. With tracing on, a
device synchronise between the two keeps the collect span free of the
device wait."""

import time


def call(system, queries, k, trace, span, sync):
    """(start, dispatched, synced, end) host times and the answers."""
    t0 = time.perf_counter()
    with span("dispatch"):
        h = system.dispatch(queries, k)
    t1 = t2 = time.perf_counter()
    if trace:
        with span("wait"):
            sync()
        t2 = time.perf_counter()
    with span("collect"):
        res = system.collect(h)
    return (t0, t1, t2, time.perf_counter()), res
