"""CUDA kernel launches a ``search`` call, counted in the profiled
stretch."""


def read(run):
    calls = run.profiled_calls()
    if run.trace is None or not calls:
        return None
    return run.trace.kernels / len(calls)
