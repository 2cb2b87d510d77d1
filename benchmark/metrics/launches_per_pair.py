"""Device kernels in the traced calls, from the profiler, over their
pairs."""


def read(run):
    if run.trace is None or not run.traced_records:
        return None
    return len(run.trace.kernels()) / len(run.traced_records)
