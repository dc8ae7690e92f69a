"""Device events (kernels, copies, fills) per window step in the trace."""


def read(trace):
    return trace.device_ops / trace.steps if trace.device_ops else None
