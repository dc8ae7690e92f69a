"""Host ms per step inside the frontend's stereo match and IMU
preintegration, the benchmark's spans around both; nothing where neither
ran."""


def read(trace):
    parts = [trace.spans[k] for k in ("frontend.stereo", "frontend.imu") if k in trace.spans]
    return sum(parts) * 1e3 / trace.steps if parts else None
