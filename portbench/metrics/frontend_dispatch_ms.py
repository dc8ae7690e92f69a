"""Host ms per step inside the program's frontend_step (the benchmark's
span around the attribute the batched step looks up)."""


def read(trace):
    s = trace.spans.get("frontend")
    return s * 1e3 / trace.steps if s is not None else None
