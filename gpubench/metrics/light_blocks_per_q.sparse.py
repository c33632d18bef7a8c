"""Posting blocks the row engine decoded into batch light banks (the
program's ``search.light_blocks`` counter) a query of the window; nothing
where the program has no such counter."""


def read(run):
    n = run.window.queries
    counters = run.window.counters
    if not n or "search.light_blocks" not in counters:
        return None
    return counters["search.light_blocks"] / n
