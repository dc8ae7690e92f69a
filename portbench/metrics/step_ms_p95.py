"""Host ms from submitting a window step to its lanes' outputs on the host,
95th percentile over every step of the window."""

import numpy as np


def read(trace):
    return float(np.percentile(trace.step_ms, 95)) if trace.step_ms else None
