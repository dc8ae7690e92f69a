"""Host ms per step inside the backend step (advance when the window is
full, ingestion, optimize), the benchmark's span around it."""


def read(trace):
    s = trace.spans.get("backend")
    return s * 1e3 / trace.steps if s is not None else None
