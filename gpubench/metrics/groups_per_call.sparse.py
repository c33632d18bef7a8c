"""Query groups the row engine split the window's batches into (the
program's ``search.compact_groups`` counter, added where a dispatch is
partitioned) a call of the window; nothing where the program has no
such counter."""


def read(run):
    calls = run.window.calls
    counters = run.window.counters
    if not calls or "search.compact_groups" not in counters:
        return None
    return counters["search.compact_groups"] / len(calls)
