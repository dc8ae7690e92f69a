"""Object-detection engines (port of dynosam_tpu/nn/detector.py).

  * `YoloV8DetectorEngine` — RGB image -> int32 instance-label image:
    YOLOv8-seg forward (nn/yolov8.py) -> DFL decode + fixed-shape NMS ->
    label image from the prototypes in one step (kernel K2's entry B on the
    card, nn/postprocess.py::mask_label_image) -> label image at the
    caller's resolution. Loads the committed checkpoint by
    default.
  * `MaskPassthroughEngine` — externally provided masks
    (prefer_provided_object_detection=True).

Labels are per frame, without temporal identity; the tracker's ByteTrack
branch gives them persistent ids.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from dynosam_tpu_torch.nn import postprocess as pp
from dynosam_tpu_torch.nn import yolov8
from dynosam_tpu_torch.nn.weights import load_flax_checkpoint


class MaskPassthroughEngine:
    """Uses externally provided masks (prefer_provided_object_detection)."""

    def __init__(self):
        self._mask = None

    def set_mask(self, mask: torch.Tensor):
        self._mask = mask

    def process(self, rgb: torch.Tensor) -> torch.Tensor:
        if self._mask is None:
            return torch.zeros(rgb.shape[:2], dtype=torch.int32, device=rgb.device)
        return self._mask


# COCO ids the reference filters to by default (person, bicycle, car,
# motorcycle, bus, truck)
DEFAULT_CLASS_FILTER = (0, 1, 2, 3, 5, 7)

# the trained checkpoint committed with the JAX package
CKPT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "dynosam_tpu", "nn", "checkpoints", "yolov8t_seg_synth.msgpack",
)


def load_checkpoint(path: str = CKPT_PATH):
    """-> (params, meta) for the committed YOLOv8-seg checkpoint: params the
    port's YoloV8Seg state_dict (float32 tensors on the CPU), meta its
    json."""
    model, meta = load_flax_checkpoint(path)
    return model.state_dict(), meta


def resize_image(img, hw):
    """(H, W, C) float image -> (h, w, C), bilinear with antialiasing when
    it shrinks (jax.image.resize "bilinear" semantics)."""
    if tuple(img.shape[:2]) == tuple(hw):
        return img
    x = img.permute(2, 0, 1)[None]
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=True)[0].permute(1, 2, 0)


def resize_labels(label, hw):
    """(h, w) int label image -> (H, W) by nearest neighbour at half-pixel
    centres (jax.image.resize "nearest", torch's "nearest-exact")."""
    if tuple(label.shape) == tuple(hw):
        return label
    x = label.to(torch.float32)[None, None]
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")[0, 0].to(torch.int32)


class YoloV8DetectorEngine:
    """YOLOv8-seg end to end: raw RGB -> instance label image."""

    def __init__(
        self,
        model: Optional[yolov8.YoloV8Seg] = None,
        *,
        input_hw=(384, 640),
        max_detections: int = 32,
        score_threshold: float = 0.25,
        iou_threshold: float = 0.6,
        class_ids: Optional[Sequence[int]] = DEFAULT_CLASS_FILTER,
        mask_threshold: float = 0.5,
        box_pad: float = 0.0,
        checkpoint: str = CKPT_PATH,
        device="cuda",
    ):
        """Default (model=None): the committed checkpoint, with its class
        count and scale from its metadata; a head of fewer than 80 classes
        is not COCO's, so the COCO class filter is dropped. The network is
        fully convolutional, so `input_hw` may differ from the training
        resolution. `box_pad` widens each box by that many pixels before
        the mask crop."""
        self.input_hw = tuple(input_hw)
        self.max_detections = max_detections
        self.score_threshold = score_threshold
        self.iou_threshold = iou_threshold
        self.mask_threshold = mask_threshold
        self.box_pad = box_pad
        if model is None:
            model, meta = load_flax_checkpoint(checkpoint)
            if meta["num_classes"] < 80:
                class_ids = None
        self.class_ids = tuple(class_ids) if class_ids is not None else None
        self.model = model.eval().to(device)

    @torch.no_grad()
    def detect(self, rgb: torch.Tensor):
        """(H, W, 3) image in 0..1 -> (label image (H, W) int32, Detections)."""
        H, W = self.input_hw
        x = resize_image(rgb.to(torch.float32), (H, W))
        out = self.model(x[None])
        single = {k: [a[0] for a in v] if isinstance(v, list) else v[0] for k, v in out.items()}
        boxes, scores, mcoef = pp.decode_all(single)
        det = pp.nms(
            boxes, scores, mcoef,
            max_detections=self.max_detections,
            score_threshold=self.score_threshold,
            iou_threshold=self.iou_threshold,
            class_ids=self.class_ids,
        )
        label = pp.mask_label_image(det, single["proto"], (H, W), mask_threshold=self.mask_threshold,
                                    box_pad=self.box_pad)
        return resize_labels(label, rgb.shape[:2]), det

    def process(self, rgb: torch.Tensor) -> torch.Tensor:
        return self.detect(rgb)[0]
