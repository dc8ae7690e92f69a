"""K1's share of its roofline: the least time of its bytes at the HBM's
rate (`portbench/k1_bytes.py`, all lanes of one launch) over the mean traced
time of the fused Shi-Tomasi kernel. Nothing where no launch was traced."""

from portbench.k1_bytes import k1_least_s

KERNEL = "shi_tomasi_cell_kernel"


def read(trace):
    times = [t for name, ts in trace.kernels.items() if KERNEL in name for t in ts]
    if not times:
        return None
    cam = trace.config["camera"]
    cell = trace.config["settings"]["frontend"]["tracker"]["detection_cell_size"]
    least = k1_least_s(trace.lanes, cam["height"], cam["width"], cell)
    return 100.0 * least / (sum(times) / len(times))
