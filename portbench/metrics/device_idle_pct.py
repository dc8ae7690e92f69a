"""Share of the traced window in which no device event ran: 1 - busy /
wall, both from the same profiled window."""


def read(trace):
    if not trace.busy_s or not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
