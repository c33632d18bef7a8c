"""Host ms a batch spends in the program's `finalize` spans
(``QueryProfiler``): ``RowExecutor.finalize`` whole, the decode of the
fused rows, the certificates and the escalations. The spans' total over
the window's calls outside the profiled stretch, a call; 0.0 where the
program recorded phases but none of this name, nothing where it
recorded no phase."""


def read(run):
    phases, calls = run.window.phases, run.host_calls()
    if not phases or not calls:
        return None
    return phases.get("finalize", {"total_us": 0.0})["total_us"] / 1e3 / len(calls)
