"""Host ms a batch spends in the program's `light` spans
(``QueryProfiler``), inside ``route``: ``RowExecutor._build_light_bank``,
the decode of a batch entry's term rows into its light bank, once a
batch entry built (a query group of a partitioned batch). The spans'
total over the window's calls outside the profiled stretch, a call;
nothing where the program recorded no phase of this name (a program
without the span)."""


def read(run):
    phases, calls = run.window.phases, run.host_calls()
    if "light" not in phases or not calls:
        return None
    return phases["light"]["total_us"] / 1e3 / len(calls)
