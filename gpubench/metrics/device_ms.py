"""Summed CUDA kernel ms a call (a batch, or a ``search``), from the
profiled stretch; ``device_ms.batch`` and ``device_ms.solo`` both read
it."""


def read(run):
    calls = run.profiled_calls()
    if run.trace is None or not calls:
        return None
    return 1e3 * run.trace.kernel_s / len(calls)
