"""Queries the row engine rescored exhaustively after a failed exactness
certificate (the program's ``search.escalations`` counter), per 1,000
queries of the window."""


def read(run):
    n = run.window.queries
    if not n:
        return None
    return 1e3 * run.window.counters.get("search.escalations", 0) / n
