"""Host ms a batch spends in the program's `copy` span
(``QueryProfiler``): the one device-to-host copy of the fused rows in
``collect_many``. The span's total over the window's calls outside the
profiled stretch, a call; 0.0 where the program recorded phases but none
of this name, nothing where it recorded no phase."""


def read(run):
    phases, calls = run.window.phases, run.host_calls()
    if not phases or not calls:
        return None
    return phases.get("copy", {"total_us": 0.0})["total_us"] / 1e3 / len(calls)
