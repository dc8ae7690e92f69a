"""dynosam_tpu_torch: the PyTorch + CUDA port of dynosam_tpu for NVIDIA Hopper.

Each module sits at the same relative path as its JAX counterpart in
`dynosam_tpu/` and keeps its public function names; `dynosam_tpu` stays the
reference that the port is tested against. The port imports no JAX: it
shares only `dynosam_tpu.config` (pure dataclasses) with the reference.

This slice covers the fused SLAM step of `parallel/batched.py` on the
provided-flow frontend and the hybrid backend (decoupled LM), up to a full
window; the window advance is not ported yet. The Shi-Tomasi corner response
runs as a hand-written CUDA kernel (`csrc/shi_tomasi.cu`).
"""

__version__ = "0.1.0"
