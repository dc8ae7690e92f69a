"""The least bytes K1 moves: the fused Shi-Tomasi response and per-cell
argmax (the port's `csrc/shi_tomasi.cu`, entry `shi_tomasi_cell_max`, one
launch for all lanes through `blockIdx.z`).

Each float32 input pixel is read once, and per full cell the best
response and its (u, v) are written once, as float32: per 384 x 1280 image
at cell 16 that is 1,966,080 + 1,920 x 12 = 1,989,120 B. The count is of
the function's work, whatever kernel computes it.
"""

HBM_BYTES_PER_S = 3.35e12      # one H100 SXM's HBM3, NVIDIA's data sheet (700 W)


def k1_bytes(lanes: int, height: int, width: int, cell: int) -> int:
    return lanes * (height * width * 4 + (height // cell) * (width // cell) * 3 * 4)


def k1_least_s(lanes: int, height: int, width: int, cell: int) -> float:
    return k1_bytes(lanes, height, width, cell) / HBM_BYTES_PER_S
