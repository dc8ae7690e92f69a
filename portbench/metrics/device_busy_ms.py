"""Device ms per window step: the profiler's raw device events (kernels,
copies, fills) summed."""


def read(trace):
    return trace.busy_s * 1e3 / trace.steps if trace.busy_s else None
