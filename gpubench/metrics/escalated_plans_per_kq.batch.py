"""Distinct plans among the queries the row engine rescored exhaustively
after a failed exactness certificate (the program's
``search.escalated_plans`` counter, one ``finalize`` at a time), per
1,000 queries of the window; nothing where the program has no such
counter."""


def read(run):
    n = run.window.queries
    counters = run.window.counters
    if not n or "search.escalated_plans" not in counters:
        return None
    return 1e3 * counters["search.escalated_plans"] / n
