"""Host ms a call spends in the program's `route` spans
(``QueryProfiler``): the row engine's dedup, purity split, partitions,
batch entry, compact build and launches, in ``dispatch_batch`` (a batch)
or around ``RowExecutor.dispatch`` in ``top_k_batch`` (a ``search``);
``route_ms.batch`` and ``route_ms.solo`` both read it. The spans' total
over the window's calls outside the profiled stretch, a call; 0.0 where
the program recorded phases but none of this name, nothing where it
recorded no phase."""


def read(run):
    phases, calls = run.window.phases, run.host_calls()
    if not phases or not calls:
        return None
    return phases.get("route", {"total_us": 0.0})["total_us"] / 1e3 / len(calls)
