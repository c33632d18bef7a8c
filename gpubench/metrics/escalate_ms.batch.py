"""Host ms a batch spends in the program's `escalate` spans
(``QueryProfiler``), inside ``finalize``: the exhaustive rescoring (B1/B2)
of the rows whose certificate failed, with its synchronous copies. The
spans' total over the window's calls outside the profiled stretch, a
call; 0.0 where the program recorded phases but none of this name (no
escalation), nothing where it recorded no phase."""


def read(run):
    phases, calls = run.window.phases, run.host_calls()
    if not phases or not calls:
        return None
    return phases.get("escalate", {"total_us": 0.0})["total_us"] / 1e3 / len(calls)
