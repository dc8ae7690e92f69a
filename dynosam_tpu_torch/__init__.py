"""dynosam_tpu_torch: the PyTorch + CUDA port of dynosam_tpu for NVIDIA Hopper.

Each module sits at the same relative path as its JAX counterpart in
`dynosam_tpu/` and keeps its public function names; `dynosam_tpu` stays the
reference that the port is tested against. The port imports nothing of the
JAX package: `config.py` is its own copy of the reference's dataclasses.

It covers the fused SLAM step of `parallel/batched.py` with every branch of
the frontend (provided flow or pyramidal KLT with CLAHE, in-loop stereo
depth, IMU preintegration with the known-rotation RANSAC) and the hybrid
backend (decoupled LM, sliding window with its advance), the detector path
(YOLOv8-seg, ByteTrack) and the host pipeline. The hand-written
CUDA kernels are in `csrc/`: the Shi-Tomasi response fused with the per-cell
argmax (`shi_tomasi.cu`) and the YOLO mask combination (`mask_combine.cu`).
Entry points that make tensors run on the card unless given a device.
"""

__version__ = "0.1.0"
