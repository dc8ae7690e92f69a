"""YOLOv8-seg post-processing: DFL decode, fixed-shape NMS, mask combination
and the instance-label image (port of dynosam_tpu/nn/postprocess.py).

Detections live in a padded (max_detections,) table with a validity mask.
`combine_masks` computes sigmoid(coef @ proto^T) through
ops/cuda/mask_combine.py (kernel K2's entry A on the card), then upsamples
x4 bilinearly, crops to the (padded) boxes and thresholds;
`mask_label_image` goes from the same inputs to the label image in one
launch of K2's entry B, which the detector calls.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from dynosam_tpu_torch.ops.cuda.mask_combine import crop_threshold, label_image, mask_combine, mask_label


class Detections(NamedTuple):
    boxes: torch.Tensor    # (K, 4) xyxy in input pixels
    scores: torch.Tensor   # (K,)
    classes: torch.Tensor  # (K,) int32
    mcoef: torch.Tensor    # (K, nm) mask coefficients
    valid: torch.Tensor    # (K,) bool


def decode_level(box_logits, cls_logits, mcoef, stride, reg_max=16):
    """One pyramid level -> (boxes_xyxy (N, 4), scores (N, nc), mcoef (N, nm)).
    Distances are E[softmax(bins)] in units of stride from anchors at cell
    centres."""
    H, W = box_logits.shape[:2]
    bl = box_logits.reshape(H, W, 4, reg_max)
    bins = torch.arange(reg_max, dtype=bl.dtype, device=bl.device)
    dist = torch.sum(torch.softmax(bl, dim=-1) * bins, dim=-1)      # (H, W, 4) ltrb
    xs = (torch.arange(W, dtype=bl.dtype, device=bl.device) + 0.5) * stride
    ys = (torch.arange(H, dtype=bl.dtype, device=bl.device) + 0.5) * stride
    cx, cy = torch.meshgrid(xs, ys, indexing="xy")
    d = dist * stride
    boxes = torch.stack([cx - d[..., 0], cy - d[..., 1], cx + d[..., 2], cy + d[..., 3]], dim=-1)
    scores = torch.sigmoid(cls_logits).reshape(H * W, -1)
    return boxes.reshape(-1, 4), scores, mcoef.reshape(H * W, -1)


def decode_all(outputs, strides: Sequence[int] = (8, 16, 32), reg_max=16):
    """All levels of one image (no batch dim) -> concatenated tables."""
    parts = [
        decode_level(bl, cl, mc, st, reg_max)
        for bl, cl, mc, st in zip(outputs["boxes"], outputs["cls"], outputs["mcoef"], strides)
    ]
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def _iou_matrix(boxes_a, boxes_b):
    """(A, 4) x (B, 4) xyxy -> (A, B) IoU."""
    ax1, ay1, ax2, ay2 = boxes_a.unbind(-1)
    bx1, by1, bx2, by2 = boxes_b.unbind(-1)
    iw = torch.clamp(torch.minimum(ax2[:, None], bx2[None, :]) - torch.maximum(ax1[:, None], bx1[None, :]),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2[:, None], by2[None, :]) - torch.maximum(ay1[:, None], by1[None, :]),
                     min=0.0)
    inter = iw * ih
    area_a = torch.clamp(ax2 - ax1, min=0.0) * torch.clamp(ay2 - ay1, min=0.0)
    area_b = torch.clamp(bx2 - bx1, min=0.0) * torch.clamp(by2 - by1, min=0.0)
    return inter / torch.clamp(area_a[:, None] + area_b[None, :] - inter, min=1e-9)


def nms(
    boxes,
    scores_nc,
    mcoef,
    *,
    max_detections: int = 32,
    pre_topk: int = 256,
    score_threshold: float = 0.25,
    iou_threshold: float = 0.6,
    class_ids: Sequence[int] | None = None,
) -> Detections:
    """Fixed-shape greedy NMS: best class per candidate (optionally only
    among `class_ids`), the top `pre_topk` by score, 8 passes of
    class-agnostic greedy suppression among them, and the top
    `max_detections` survivors as a
    padded table. Scores tie often (under the threshold they are 0, and a
    confident class saturates sigmoid to exactly 1.0 in f32), so the top
    `pre_topk` come from a stable descending sort: among equal scores the
    lower candidate index first, as `lax.top_k` orders them."""
    nc = scores_nc.shape[-1]
    dev = scores_nc.device
    if class_ids is not None:
        keep = torch.zeros((nc,), dtype=torch.bool, device=dev)
        keep[list(class_ids)] = True
        scores_nc = torch.where(keep[None, :], scores_nc, 0.0)
    cls = torch.argmax(scores_nc, dim=-1).to(torch.int32)
    score = torch.amax(scores_nc, dim=-1)
    score = torch.where(score >= score_threshold, score, 0.0)

    k = min(pre_topk, score.shape[0])
    top_i = torch.argsort(score, descending=True, stable=True)[:k]
    top_s = score[top_i]
    top_b, top_c, top_m = boxes[top_i], cls[top_i], mcoef[top_i]

    iou = _iou_matrix(top_b, top_b)
    rank = torch.arange(k, device=dev)
    higher = rank[None, :] < rank[:, None]            # (i, j): j ranked above i
    overlap = (iou > iou_threshold) & higher

    # a candidate dies iff an alive higher-ranked one overlaps it; 8 passes
    # as in the reference (exact for suppression chains up to that length)
    alive = top_s > 0.0
    for _ in range(8):
        alive = (top_s > 0.0) & ~torch.any(overlap & alive[None, :], dim=1)

    order = torch.argsort(torch.where(alive, -top_s, torch.inf), stable=True)
    sel = order[:max_detections]
    valid = alive[sel] & (top_s[sel] > 0.0)
    return Detections(
        boxes=top_b[sel],
        scores=torch.where(valid, top_s[sel], 0.0),
        classes=torch.where(valid, top_c[sel], -1).to(torch.int32),
        mcoef=top_m[sel],
        valid=valid,
    )


def combine_masks(
    det: Detections,
    proto,                      # (Hp, Wp, nm) prototype basis (input / 4)
    out_hw,                     # (H, W) of the network input
    mask_threshold: float = 0.5,
    box_pad: float = 0.0,
):
    """Per-instance masks: sigmoid(coef @ proto^T) through the K2 wrapper's
    entry A (the prototype in the network's own layout), upsampled to the
    input size, zeroed outside the box widened by `box_pad` pixels and
    thresholded -> (K, H, W) bool."""
    low = mask_combine(proto, det.mcoef)                                # (K, Hp, Wp)
    return crop_threshold(low, det.boxes, det.valid, out_hw, mask_threshold, box_pad)


def masks_to_label_image(masks, scores):
    """(K, H, W) bool + (K,) scores -> (H, W) int32 label image: 0 for the
    background, 1..K by detection index, overlaps to the higher score."""
    return label_image(masks, scores)


def mask_label_image(det: Detections, proto, out_hw, mask_threshold: float = 0.5,
                     box_pad: float = 0.0):
    """`masks_to_label_image(combine_masks(...), det.scores)` as one step:
    the K2 wrapper's entry B, one launch on the card, no (K, H, W) array;
    the plain composition on the CPU -> (H, W) int32."""
    return mask_label(proto, det.mcoef, det.boxes, det.scores, det.valid, out_hw,
                      mask_threshold=mask_threshold, box_pad=box_pad)
