"""Host ms a batch spends in ``IndexSearcher.collect_many`` (the copy of
the fused rows, ``finalize`` with its escalations, the TopDocs): the mean
of the harness's span around the call, which starts after a
``torch.cuda.synchronize()``, over the calls outside the profiled
stretch."""


def read(run):
    calls = run.host_calls()
    if not calls:
        return None
    return 1e3 * sum(c.end - c.synced for c in calls) / len(calls)
