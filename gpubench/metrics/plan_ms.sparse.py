"""Host ms a batch spends in the program's `plan` span inside
``SparseSearcher.dispatch_batch`` (``QueryProfiler``): the row plans of
the batch's sparse vectors. The span's total over the window's calls
outside the profiled stretch, a call; nothing where the program recorded
no phase of this name (a program without the span)."""


def read(run):
    phases, calls = run.window.phases, run.host_calls()
    if "plan" not in phases or not calls:
        return None
    return phases["plan"]["total_us"] / 1e3 / len(calls)
