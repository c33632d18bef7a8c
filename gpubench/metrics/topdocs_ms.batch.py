"""Host ms a batch spends in the program's `topdocs` span
(``QueryProfiler``): the TopDocs of ``collect_many``, one a query and
segment, and their merge. The span's total over the window's calls
outside the profiled stretch, a call; 0.0 where the program recorded
phases but none of this name, nothing where it recorded no phase."""


def read(run):
    phases, calls = run.window.phases, run.host_calls()
    if not phases or not calls:
        return None
    return phases.get("topdocs", {"total_us": 0.0})["total_us"] / 1e3 / len(calls)
