"""Host ms a batch spends in ``IndexSearcher.dispatch_batch`` (planning,
routing and launches): the mean of the harness's span around the call,
over the window's calls outside the profiled stretch."""


def read(run):
    calls = run.host_calls()
    if not calls:
        return None
    return 1e3 * sum(c.dispatched - c.start for c in calls) / len(calls)
