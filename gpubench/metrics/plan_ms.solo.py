"""Host ms of the searcher's ``plan`` phase (``QueryProfiler``) a planned
``search`` call, over the calls outside the profiled stretch."""


def read(run):
    plan = run.window.phases.get("plan")
    if not plan or plan["count"] <= 0:
        return None
    return plan["total_us"] / plan["count"] / 1e3
