"""A frozen copy of `dynosam_tpu_torch`'s batched SLAM step, the benchmark's
plain reference.

The modules are copied from the port as it stood when the benchmark was
written, imports renamed to this package, with two changes: the Shi-Tomasi
kernel's plain PyTorch form stands in for the kernel
(`ops/cuda/shi_tomasi.py`), and the window advance factorises the departing
window in float64 (`backend/window.py::_eliminate_and_roll`). Later changes
to the port leave this copy as it is, so the port's outputs are always held
to the same arithmetic. Nothing here imports the port, JAX or the JAX
package.
"""
